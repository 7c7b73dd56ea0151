"""Link (edge-seed) loader.

Counterpart of ``graphlearn_tpu/loader/link_loader.py``: batches of seed
edges go through link sampling (negatives, the endpoints' node
expansion) and the node loader's collate; the batch metadata carries
``edge_label_index`` / ``edge_label`` (binary, or no negatives) or
``src_index`` / ``dst_pos_index`` / ``dst_neg_index`` (triplet). Typed
seed edges ``(edge_type, [2, E])`` over a typed dataset collate into
``HeteroData`` (per featured type one row gather), the metadata indexing
each type's node buffer. The calibrated-caps overflow guard and the
mid-epoch resume are the node loader's; ``overflow_policy='recompute'``
is refused on a typed graph, as in JAX (its batches have no replayable
key). Link batches train in the per-step loop
(``models.train.make_link_train_step``): the epoch trainers take node
loaders only, as in JAX.
"""
from typing import Optional

import numpy as np

from ..data import Dataset
from ..sampler import EdgeSamplerInput, NegativeSampling
from ..typing import split_edge_type_seeds
from .node_loader import NodeLoader, SeedBatcher, loader_device


class LinkLoader(NodeLoader):
  """Sample-and-collate loader over seed edges ``edge_label_index``
  (``[2, E]``, or a typed ``(edge_type, [2, E])`` pair). ``to_device``
  (or its alias ``device=``; None means the card) must hold the
  dataset."""

  def __init__(self, data: Dataset, link_sampler, edge_label_index,
               edge_label=None,
               neg_sampling: Optional[NegativeSampling] = None,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, to_device=None,
               seed: Optional[int] = None, overflow_policy: str = 'raise',
               device=None):
    del with_edge   # carried by the sampler
    self._check_device(data, loader_device(to_device, device))
    self.edge_type, edge_label_index = \
        split_edge_type_seeds(edge_label_index)
    eli = np.asarray(edge_label_index)
    self.rows, self.cols = eli[0].reshape(-1), eli[1].reshape(-1)
    self.edge_label = (np.asarray(edge_label).reshape(-1)
                       if edge_label is not None else None)
    self.neg_sampling = NegativeSampling.cast(neg_sampling)
    self.data = data
    self.sampler = link_sampler
    self.batch_size = batch_size
    self.collect_features = collect_features
    self.input_type = self.edge_type
    self._init_overflow_policy(overflow_policy)
    self._batcher = SeedBatcher(len(self.rows), batch_size, shuffle,
                                drop_last, seed)

  def __iter__(self):
    guarded, recompute = self._overflow_epoch_start()
    for idx in self._batcher:
      inputs = EdgeSamplerInput(
          row=self.rows[idx], col=self.cols[idx],
          label=self.edge_label[idx] if self.edge_label is not None else
          None, input_type=self.edge_type, neg_sampling=self.neg_sampling)
      if recompute:
        key = self.sampler._next_key()
        out = self.sampler.sample_from_edges(inputs, key=key)
        if self._batch_overflowed(out):
          self.overflow_recomputes += 1
          out = self._replay_sampler().sample_from_edges(inputs, key=key)
      else:
        out = self.sampler.sample_from_edges(inputs)
        if guarded:
          self._accumulate_overflow(out)
      yield self._collate_fn(out)
    if guarded and not recompute:
      self._finish_epoch_overflow()
