"""Hotness-aware (access-frequency) partitioning with per-partition caches
(counterpart of ``graphlearn_tpu/partition/frequency_partitioner.py``):
given per-partition access-probability vectors (from pre-sampling,
``NeighborSampler.sample_prob``), node chunks are greedily assigned to
the partition where they are hottest (subject to balance), and each
partition hot-caches its top remotely-owned nodes under a cache budget,
which feeds the device-resident hot prefix of its Feature store. The
choice is made on host numpy probabilities: the same probabilities give
the same partitions in both packages."""
from typing import List, Optional

import numpy as np

from ..typing import NodeType
from .base import PartitionerBase


class FrequencyPartitioner(PartitionerBase):
  """``PartitionerBase`` over access probabilities.

  Args:
    probs: per-partition access-probability vectors — list of [num_nodes]
      arrays (numpy, or host tensors), one per target partition (homo),
      or dict ntype -> list.
    cache_ratio: fraction of a partition's nodes to hot-cache.
  """

  def __init__(self, output_dir, num_parts, num_nodes, edge_index,
               probs: List[np.ndarray], node_feat=None, edge_feat=None,
               edge_weights=None, edge_assign_strategy='by_src',
               chunk_size=10000, cache_ratio: float = 0.0,
               seed: Optional[int] = None):
    super().__init__(output_dir, num_parts, num_nodes, edge_index,
                     node_feat, edge_feat, edge_weights,
                     edge_assign_strategy, chunk_size)
    self.probs = probs
    self.cache_ratio = cache_ratio
    self._node_pb = {}
    del seed

  def _get_probs(self, ntype):
    return self.probs[ntype] if isinstance(self.probs, dict) else self.probs

  def _partition_node(self, ntype: Optional[NodeType]) -> np.ndarray:
    """Greedy chunk assignment maximizing local hotness under balance."""
    n = (self.num_nodes[ntype] if isinstance(self.num_nodes, dict)
         else self.num_nodes)
    probs = [np.asarray(p) for p in self._get_probs(ntype)]
    assert len(probs) == self.num_parts
    chunk = self.chunk_size
    num_chunks = (n + chunk - 1) // chunk
    # score[c, p] = how hot chunk c is for partition p
    score = np.zeros((num_chunks, self.num_parts))
    for p in range(self.num_parts):
      padded = np.zeros(num_chunks * chunk)
      padded[:n] = probs[p][:n]
      score[:, p] = padded.reshape(num_chunks, chunk).sum(1)
    cap = (num_chunks + self.num_parts - 1) // self.num_parts
    counts = np.zeros(self.num_parts, dtype=np.int64)
    pb = np.empty(n, dtype=np.int32)
    # hottest chunks pick first (stable greedy, like the reference's
    # per-chunk argmax with capacity)
    order = np.argsort(-score.max(axis=1))
    for c in order:
      for p in np.argsort(-score[c]):
        if counts[p] < cap:
          lo, hi = c * chunk, min((c + 1) * chunk, n)
          pb[lo:hi] = p
          counts[p] += 1
          break
    self._node_pb[ntype] = pb
    return pb

  def _cache_node(self, ntype: Optional[NodeType],
                  part: int) -> Optional[np.ndarray]:
    """Top-hot nodes for `part` under the cache budget."""
    if self.cache_ratio <= 0:
      return None
    n = (self.num_nodes[ntype] if isinstance(self.num_nodes, dict)
         else self.num_nodes)
    budget = int(n * self.cache_ratio / self.num_parts)
    if budget <= 0:
      return None
    prob = np.asarray(self._get_probs(ntype)[part])[:n]
    pb = self._node_pb[ntype]
    # cache only remotely-owned hot nodes (local ones are already local)
    remote_hot = np.where((pb != part) & (prob > 0))[0]
    if remote_hot.size == 0:
      return None
    top = remote_hot[np.argsort(-prob[remote_hot])][:budget]
    return np.sort(top)
