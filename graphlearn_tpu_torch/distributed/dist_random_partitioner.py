"""The shared partition book of the distributed partitioner.

Counterpart of ``shared_node_pb`` in
``graphlearn_tpu/distributed/dist_random_partitioner.py``: every rank
computes the same book from a seed, so none is broadcast. The
partitioner itself (``DistRandomPartitioner``) needs the RPC layer and
comes with the remote stack.
"""
import numpy as np


def shared_node_pb(num_nodes: int, num_parts: int, seed: int) -> np.ndarray:
  """A seeded shuffle of the ``num_nodes`` ids dealt in equal contiguous
  shares: ``[num_nodes]`` int32 owning partitions, equal on every rank."""
  rng = np.random.default_rng(seed)
  perm = rng.permutation(num_nodes)
  pb = np.empty(num_nodes, dtype=np.int32)
  share = (num_nodes + num_parts - 1) // num_parts
  for p in range(num_parts):
    pb[perm[p * share:(p + 1) * share]] = p
  return pb
