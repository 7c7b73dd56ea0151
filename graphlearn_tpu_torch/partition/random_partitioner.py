"""Random node partitioning (counterpart of
``graphlearn_tpu/partition/random_partitioner.py``): node ids are
shuffled by numpy's ``default_rng(seed)``, as in JAX, and dealt in equal
contiguous shares, so both packages give the same partition books."""
from typing import Optional

import numpy as np

from ..typing import NodeType
from .base import PartitionerBase


class RandomPartitioner(PartitionerBase):
  """``PartitionerBase`` over a seeded shuffle (``seed``: the numpy
  generator's, shared by every node type in order)."""

  def __init__(self, output_dir, num_parts, num_nodes, edge_index,
               node_feat=None, edge_feat=None, edge_weights=None,
               edge_assign_strategy='by_src', chunk_size=10000,
               seed: Optional[int] = None):
    super().__init__(output_dir, num_parts, num_nodes, edge_index,
                     node_feat, edge_feat, edge_weights,
                     edge_assign_strategy, chunk_size)
    self._rng = np.random.default_rng(seed)

  def _partition_node(self, ntype: Optional[NodeType]) -> np.ndarray:
    n = (self.num_nodes[ntype] if isinstance(self.num_nodes, dict)
         else self.num_nodes)
    perm = self._rng.permutation(n)
    pb = np.empty(n, dtype=np.int32)
    # shuffled ids dealt round-robin in equal contiguous shares
    share = (n + self.num_parts - 1) // self.num_parts
    for p in range(self.num_parts):
      pb[perm[p * share:(p + 1) * share]] = p
    return pb
