"""LinkNeighborLoader: the fanout link loader.

Counterpart of ``graphlearn_tpu/loader/link_neighbor_loader.py``: a
``NeighborSampler`` over the dataset's graph driving ``LinkLoader``; on a
typed dataset the fanouts may be a dict by edge type and the seed edges
an ``(edge_type, [2, E])`` pair.
``frontier_caps='auto'`` calibrates the merge engine's caps at the link
batch's seed width (``calibrate.link_seed_width``: both endpoints of
each positive and the negatives' seeds), probing from the positives'
endpoints.
"""
from typing import Optional

import numpy as np

from ..data import Dataset
from ..sampler import NegativeSampling, NeighborSampler
from ..sampler.calibrate import estimate_frontier_caps, link_seed_width
from ..typing import split_edge_type_seeds
from .link_loader import LinkLoader
from .node_loader import loader_device


class LinkNeighborLoader(LinkLoader):
  """``to_device`` (or its alias ``device=``; None means the card) must
  hold the dataset."""

  def __init__(self, data: Dataset, num_neighbors, edge_label_index,
               edge_label=None,
               neg_sampling: Optional[NegativeSampling] = None,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               with_weight: bool = False, strategy: str = 'random',
               collect_features: bool = True, to_device=None,
               seed: Optional[int] = None, node_budget=None,
               dedup: str = 'auto', frontier_caps=None,
               overflow_policy: str = 'raise', device=None):
    device = loader_device(to_device, device)
    if isinstance(frontier_caps, str):
      if frontier_caps != 'auto':
        raise ValueError(f'frontier_caps={frontier_caps!r}: pass a list '
                         "of per-hop caps or 'auto'")
      if isinstance(data.graph, dict) or \
          split_edge_type_seeds(edge_label_index)[0] is not None:
        raise ValueError(
            "frontier_caps='auto' is homogeneous-only; on hetero "
            'datasets pass the {edge_type: [per-hop caps]} dict from '
            'calibrate.estimate_hetero_frontier_caps')
      eli = np.asarray(edge_label_index)
      # the probe pool: the positives' endpoints (negatives are uniform
      # nodes, whose neighbourhoods the endpoints' bound from above)
      pool = np.concatenate([eli[0].reshape(-1), eli[1].reshape(-1)])
      frontier_caps = estimate_frontier_caps(
          data.graph, list(num_neighbors),
          link_seed_width(batch_size, NegativeSampling.cast(neg_sampling)),
          input_nodes=pool, seed=seed or 0)
    sampler = NeighborSampler(
        data.graph, num_neighbors, device=device, with_edge=with_edge,
        with_weight=with_weight, strategy=strategy, seed=seed,
        node_budget=node_budget, dedup=dedup, frontier_caps=frontier_caps,
        edge_dir=data.edge_dir)
    super().__init__(data, sampler, edge_label_index, edge_label,
                     neg_sampling, batch_size, shuffle, drop_last,
                     with_edge, collect_features, device, seed,
                     overflow_policy=overflow_policy)
