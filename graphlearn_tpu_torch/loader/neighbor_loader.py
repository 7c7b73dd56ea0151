"""NeighborLoader: fanout-sampling node loader.

Counterpart of ``graphlearn_tpu/loader/neighbor_loader.py``: builds a
``NeighborSampler`` over the dataset's graph and drives ``NodeLoader``
with it. This slice ports ``dedup='tree'``; the sampler raises for the
options later slices port.
"""
from typing import Optional

from ..data import Dataset
from ..sampler import NeighborSampler
from ..utils import resolve_device
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """``device=None`` means the card (it must hold the dataset)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               with_weight: bool = False, strategy: str = 'random',
               device=None, seed: Optional[int] = None, node_budget=None,
               dedup: str = 'tree', padded_window=None,
               seed_labels_only: bool = False, frontier_caps=None):
    device = resolve_device(device)
    sampler = NeighborSampler(
        data.graph, num_neighbors, device=device, with_edge=with_edge,
        with_weight=with_weight, strategy=strategy, seed=seed,
        node_budget=node_budget, dedup=dedup, padded_window=padded_window,
        frontier_caps=frontier_caps)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, device, seed,
                     seed_labels_only=seed_labels_only)
