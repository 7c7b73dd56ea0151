"""SubGraphLoader: k-hop induced-subgraph batches.

Counterpart of ``graphlearn_tpu/loader/subgraph_loader.py``: each batch
is the whole induced subgraph over the k-hop expansion of its seeds
(``NeighborSampler.subgraph``: exact, or degree-bucketed), with
``metadata['mapping']`` locating each seed in ``node``.
"""
from typing import Optional

from ..data import Dataset
from ..sampler import NeighborSampler, NodeSamplerInput
from .node_loader import NodeLoader, loader_device


class SubGraphLoader(NodeLoader):
  """``to_device`` (or its alias ``device=``; None means the card) must
  hold the dataset."""

  def __init__(self, data: Dataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, to_device=None,
               seed: Optional[int] = None,
               max_degree: Optional[int] = None, bucketed: bool = False,
               cap_large: Optional[int] = None, device=None):
    device = loader_device(to_device, device)
    sampler = NeighborSampler(data.graph, num_neighbors, device=device,
                              with_edge=with_edge, seed=seed,
                              edge_dir=data.edge_dir)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, with_edge, collect_features, device, seed)
    self.max_degree = max_degree
    self.bucketed = bucketed
    self.cap_large = cap_large

  def __iter__(self):
    for idx in self._batcher:
      out = self.sampler.subgraph(
          NodeSamplerInput(self.input_seeds[idx], self.input_type),
          max_degree=self.max_degree, bucketed=self.bucketed,
          cap_large=self.cap_large)
      yield self._collate_fn(out)
