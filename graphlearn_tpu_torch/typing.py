"""Type aliases shared by the port (the part of ``graphlearn_tpu/typing.py``
the homogeneous slice needs)."""
from typing import Tuple

# A node type in a heterogeneous graph, e.g. 'paper'.
NodeType = str

# An edge type triplet (src_node_type, relation, dst_node_type).
EdgeType = Tuple[str, str, str]
