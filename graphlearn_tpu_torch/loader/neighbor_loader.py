"""NeighborLoader: fanout-sampling node loader.

Counterpart of ``graphlearn_tpu/loader/neighbor_loader.py``: builds a
``NeighborSampler`` over the dataset's graph and drives ``NodeLoader``
with it. ``dedup='auto'`` (the default, as in the JAX package) runs the
merge exact-dedup engine, ``dedup='tree'`` the tree engine;
``frontier_caps='auto'`` calibrates the merge engine's caps against this
loader's own seed pool and batch size (``sampler.calibrate``). On a
heterogeneous dataset the seeds are typed (``('paper', ids)``), the
fanouts a list or a per-edge-type dict, and calibrated caps the
``{edge_type: [per-hop caps]}`` dict of
``calibrate.estimate_hetero_frontier_caps``.
"""
from typing import Optional

from ..data import Dataset
from ..sampler import NeighborSampler
from ..sampler.calibrate import estimate_frontier_caps
from .node_loader import NodeLoader, loader_device


class NeighborLoader(NodeLoader):
  """``to_device`` (or its alias ``device=``; None means the card) must
  hold the dataset."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               with_weight: bool = False, strategy: str = 'random',
               collect_features: bool = True, to_device=None,
               seed: Optional[int] = None, node_budget=None,
               dedup: str = 'auto', padded_window=None,
               seed_labels_only: bool = False, frontier_caps=None,
               overflow_policy: str = 'raise', device=None):
    device = loader_device(to_device, device)
    if isinstance(frontier_caps, str):
      if frontier_caps != 'auto':
        raise ValueError(f'frontier_caps={frontier_caps!r}: pass a list '
                         "of per-hop caps or 'auto'")
      if isinstance(data.graph, dict):
        raise ValueError(
            "frontier_caps='auto' is homogeneous-only; on hetero "
            'datasets pass the {edge_type: [per-hop caps]} dict from '
            'calibrate.estimate_hetero_frontier_caps')
      pool = (input_nodes[1] if isinstance(input_nodes, tuple)
              else input_nodes)
      frontier_caps = estimate_frontier_caps(
          data.graph, list(num_neighbors), batch_size, input_nodes=pool,
          seed=seed or 0)
    sampler = NeighborSampler(
        data.graph, num_neighbors, device=device, with_edge=with_edge,
        with_weight=with_weight, strategy=strategy, seed=seed,
        node_budget=node_budget, dedup=dedup, padded_window=padded_window,
        frontier_caps=frontier_caps, edge_dir=data.edge_dir)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, with_edge, collect_features, device, seed,
                     seed_labels_only=seed_labels_only,
                     overflow_policy=overflow_policy)
