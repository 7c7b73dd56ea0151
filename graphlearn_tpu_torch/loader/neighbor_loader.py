"""NeighborLoader: fanout-sampling node loader.

Counterpart of ``graphlearn_tpu/loader/neighbor_loader.py``: builds a
``NeighborSampler`` over the dataset's graph and drives ``NodeLoader``
with it. ``dedup='auto'`` (the default, as in the JAX package) runs the
merge exact-dedup engine, ``dedup='tree'`` the tree engine;
``frontier_caps='auto'`` calibrates the merge engine's caps against this
loader's own seed pool and batch size (``sampler.calibrate``).
"""
from typing import Optional

from ..data import Dataset
from ..sampler import NeighborSampler
from ..sampler.calibrate import estimate_frontier_caps
from ..utils import resolve_device
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """``device=None`` means the card (it must hold the dataset)."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               with_weight: bool = False, strategy: str = 'random',
               device=None, seed: Optional[int] = None, node_budget=None,
               dedup: str = 'auto', padded_window=None,
               seed_labels_only: bool = False, frontier_caps=None,
               overflow_policy: str = 'raise'):
    device = resolve_device(device)
    if isinstance(frontier_caps, str):
      if frontier_caps != 'auto':
        raise ValueError(f'frontier_caps={frontier_caps!r}: pass a list '
                         "of per-hop caps or 'auto'")
      pool = (input_nodes[1] if isinstance(input_nodes, tuple)
              else input_nodes)
      frontier_caps = estimate_frontier_caps(
          data.graph, list(num_neighbors), batch_size, input_nodes=pool,
          seed=seed or 0)
    sampler = NeighborSampler(
        data.graph, num_neighbors, device=device, with_edge=with_edge,
        with_weight=with_weight, strategy=strategy, seed=seed,
        node_budget=node_budget, dedup=dedup, padded_window=padded_window,
        frontier_caps=frontier_caps)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, device, seed,
                     seed_labels_only=seed_labels_only,
                     overflow_policy=overflow_policy)
