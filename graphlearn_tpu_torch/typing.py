"""Type aliases, the canonical string forms of node and edge types, the
typed seed-edge convention and the partition containers shared by the
port (the part of ``graphlearn_tpu/typing.py`` the sampling, model and
partition paths need)."""
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

# A node type in a heterogeneous graph, e.g. 'paper'.
NodeType = str

# An edge type triplet (src_node_type, relation, dst_node_type).
EdgeType = Tuple[str, str, str]

# Prefix marking the reverse direction of an edge type.
REVERSE_PREFIX = 'rev_'

# String join token for edge types.
EDGE_TYPE_STR_SPLIT = '__'

# Seeds: bare ids, or (type, ids) on a typed graph.
InputNodes = Union[np.ndarray, Tuple[NodeType, np.ndarray]]
InputEdges = Union[np.ndarray, Tuple[EdgeType, np.ndarray]]
NumNeighbors = Union[List[int], Dict[EdgeType, List[int]]]

# A partition book: global id -> owning partition (a host int array).
PartitionBook = np.ndarray
HeteroNodePartitionDict = Dict[NodeType, PartitionBook]
HeteroEdgePartitionDict = Dict[EdgeType, PartitionBook]


class GraphPartitionData(NamedTuple):
  """The edges of one graph partition, in global ids."""
  edge_index: np.ndarray          # [2, E_local] (row, col)
  eids: np.ndarray                # [E_local] global edge ids
  weights: Optional[np.ndarray] = None  # [E_local] edge weights


class FeaturePartitionData(NamedTuple):
  """The feature rows of one partition and its hot cache."""
  feats: Optional[np.ndarray]        # [n_local, F]
  ids: Optional[np.ndarray]          # [n_local] global ids
  cache_feats: Optional[np.ndarray]  # [n_cache, F] hot-cache rows
  cache_ids: Optional[np.ndarray]    # [n_cache] global ids of cached rows


HeteroGraphPartitionDict = Dict[EdgeType, GraphPartitionData]
HeteroFeaturePartitionDict = Dict[Union[NodeType, EdgeType],
                                  FeaturePartitionData]


def as_str(type_: Union[NodeType, EdgeType]) -> str:
  """Canonical string form of a node or edge type."""
  if isinstance(type_, NodeType):
    return type_
  if isinstance(type_, (list, tuple)) and len(type_) == 3:
    return EDGE_TYPE_STR_SPLIT.join(type_)
  return ''


def to_edge_type(type_str: str) -> EdgeType:
  parts = type_str.split(EDGE_TYPE_STR_SPLIT)
  if len(parts) != 3:
    raise ValueError(f'invalid edge type string: {type_str!r}')
  return tuple(parts)


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


def reverse_edge_type(etype: EdgeType) -> EdgeType:
  """Reverse of an edge type: flips endpoints and toggles the 'rev_' prefix."""
  src, rel, dst = etype
  if src != dst:
    if rel.startswith(REVERSE_PREFIX):
      rel = rel[len(REVERSE_PREFIX):]
    else:
      rel = REVERSE_PREFIX + rel
  return (dst, rel, src)
