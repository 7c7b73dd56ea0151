"""Type aliases and the typed seed-edge convention shared by the port (the
part of ``graphlearn_tpu/typing.py`` the homogeneous slices need)."""
from typing import Tuple

# A node type in a heterogeneous graph, e.g. 'paper'.
NodeType = str

# An edge type triplet (src_node_type, relation, dst_node_type).
EdgeType = Tuple[str, str, str]


def split_edge_type_seeds(edge_label_index):
  """The typed seed-edge convention: ``((src, rel, dst), [2, E])`` ->
  ``(etype, edges)``; anything else -> ``(None, edges)``. The all-strings
  check keeps a homogeneous ``(rows, cols)`` pair of exactly 3 edges from
  being read as a typed tuple."""
  if isinstance(edge_label_index, tuple) and \
      len(edge_label_index) == 2 and \
      isinstance(edge_label_index[0], (tuple, list)) and \
      len(edge_label_index[0]) == 3 and \
      all(isinstance(s, str) for s in edge_label_index[0]):
    return tuple(edge_label_index[0]), edge_label_index[1]
  return None, edge_label_index
