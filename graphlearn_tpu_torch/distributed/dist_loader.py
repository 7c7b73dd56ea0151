"""Distributed loaders: per-shard batches over the mesh.

Counterpart of the collocated loaders of
``graphlearn_tpu/distributed/dist_loader.py``: every iteration draws P
seed blocks (one per shard), runs the distributed sample and yields one
``Data`` whose fields carry the leading shard axis ``[L, ...]`` (all P
shards on a one-process mesh, this rank's under a process group, where
every rank draws the same seed order from the same ``seed``), or a
``HeteroData`` for typed seeds (``('ntype', ids)``). The calibrated-caps
overflow guard is the single-device loaders' (``OverflowGuardMixin``).
``DistLinkNeighborLoader`` yields link batches (per-shard seed-edge
blocks, shard-local negatives), ``DistSubGraphLoader`` induced
subgraphs. The multiprocess and remote loaders come with a later slice.
"""
from typing import List, Optional

import numpy as np

from .. import ops
from ..loader.node_loader import OverflowGuardMixin
from ..loader.transform import Data, HeteroData
from ..sampler import EdgeSamplerInput, HeteroSamplerOutput, NodeSamplerInput
from ..typing import reverse_edge_type
from ..typing import split_edge_type_seeds as _split_edge_type
from .dist_dataset import DistDataset
from .dist_neighbor_sampler import DistNeighborSampler


def _split_input_type(input_nodes):
  """The seed convention: ``('ntype', ids)`` for typed seeds, a bare
  array otherwise."""
  if isinstance(input_nodes, tuple) and len(input_nodes) == 2 and \
      isinstance(input_nodes[0], str):
    return input_nodes[0], input_nodes[1]
  return None, input_nodes


def _mesh_or_context(mesh):
  if mesh is None:
    from .dist_context import get_context
    ctx = get_context()
    mesh = ctx.mesh if ctx else None
  return mesh


class DistLoader(OverflowGuardMixin):
  """Sample-and-collate over P seed blocks per step."""

  def __init__(self, data: DistDataset, sampler: DistNeighborSampler,
               input_nodes, batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = True, collect_features: bool = True,
               seed: Optional[int] = None,
               seed_labels_only: bool = False,
               overflow_policy: str = 'raise'):
    self.data = data
    self.sampler = sampler
    self._init_overflow_policy(overflow_policy)
    self.seed_labels_only = seed_labels_only
    self.input_type, input_nodes = _split_input_type(input_nodes)
    self.input_seeds = np.asarray(input_nodes).reshape(-1)
    self.batch_size = batch_size  # per shard
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.collect_features = collect_features
    self.seed = seed
    self._rng = np.random.default_rng(seed)
    self.num_partitions = data.num_partitions

  def __len__(self):
    g = self.num_partitions * self.batch_size
    n = self._num_seeds()
    return n // g if self.drop_last else (n + g - 1) // g

  def _num_seeds(self):
    return self.input_seeds.shape[0]

  def state_dict(self):
    """Resumable iteration state (epoch-boundary granularity): the seed
    shuffle stream and the sampler's PRNG state."""
    return {'rng_state': self._rng.bit_generator.state,
            'sampler': self.sampler.state_dict()}

  def load_state_dict(self, state):
    self._rng.bit_generator.state = state['rng_state']
    if 'sampler' in state:
      self.sampler.load_state_dict(state['sampler'])

  def _index_blocks(self):
    """``([P, B] seed-index blocks, validity mask or None)`` per step.
    The final short block is padded by repeating indices and carries a
    mask: pad seeds produce no nodes or edges."""
    n = self._num_seeds()
    order = self._rng.permutation(n) if self.shuffle else np.arange(n)
    g = self.num_partitions * self.batch_size
    shape = (self.num_partitions, self.batch_size)
    for s in range(len(self)):
      idx = order[s * g:(s + 1) * g]
      n_valid = idx.shape[0]
      mask = None
      if n_valid < g:
        idx = np.concatenate([idx, np.resize(order, g - n_valid)])
        mask = (np.arange(g) < n_valid).reshape(shape)
      yield idx.reshape(shape), mask

  def __iter__(self):
    guarded, recompute = self._overflow_epoch_start()
    for idx, mask in self._index_blocks():
      inp = NodeSamplerInput(self.input_seeds[idx], self.input_type)
      if recompute:
        keys = self.sampler._next_keys()
        out = self.sampler.sample_from_nodes(inp, seed_mask=mask, keys=keys)
        if self._batch_overflowed(out):
          self.overflow_recomputes += 1
          out = self._replay_sampler().sample_from_nodes(
              inp, seed_mask=mask, keys=keys)
      else:
        out = self.sampler.sample_from_nodes(inp, seed_mask=mask)
        if guarded:
          self._accumulate_overflow(out)
      yield self._collate_fn(out)
    if guarded and not recompute:
      self._finish_epoch_overflow()

  def _collate_fn(self, out):
    """A ``SamplerOutput`` ``[L, ...]`` -> a stacked ``Data`` (a
    ``HeteroSamplerOutput`` -> a ``HeteroData``)."""
    x, y = self.sampler.collate(
        out, self.data.node_labels,
        label_cap=(self.batch_size if self.seed_labels_only else None))
    if isinstance(out, HeteroSamplerOutput):
      ei = {et: ops.stack2_batched(out.row[et], out.col[et])
            for et in out.row}
      edge_attr = None
      efs = getattr(self.data, 'edge_features', None)
      if out.edge is not None and efs:
        # batches key edges by the message-direction (reversed) type; the
        # ids belong to the stored edge type's id space
        edge_attr = {}
        for et in out.edge:
          src_et = (reverse_edge_type(et) if self.data.edge_dir == 'out'
                    else et)
          if src_et in efs:
            edge_attr[et] = efs[src_et].get(out.edge[et])
        edge_attr = edge_attr or None
      return HeteroData(node=out.node, num_nodes=out.num_nodes,
                        edge_index=ei, edge_mask=out.edge_mask, x=x, y=y,
                        edge_ids=out.edge, edge_attr=edge_attr,
                        batch=out.batch, batch_size=out.batch_size,
                        num_sampled_nodes=out.num_sampled_nodes,
                        num_sampled_edges=out.num_sampled_edges,
                        metadata=dict(out.metadata))
    edge_attr = None
    if out.edge is not None and \
        getattr(self.data, 'edge_features', None) is not None:
      edge_attr = self.data.edge_features.get(out.edge)
    ei = ops.stack2_batched(out.row, out.col)      # [L, 2, E]
    return Data(node=out.node, num_nodes=out.num_nodes,
                edge_index=ei, edge_mask=out.edge_mask, x=x, y=y,
                edge_ids=out.edge, edge_attr=edge_attr, batch=out.batch,
                batch_size=out.batch_size,
                num_sampled_nodes=out.num_sampled_nodes,
                num_sampled_edges=out.num_sampled_edges,
                metadata=dict(out.metadata))


class DistLinkNeighborLoader(DistLoader):
  """The distributed link-prediction loader: per-shard seed-edge blocks
  through ``DistNeighborSampler.sample_from_edges``.

  Args (beyond ``DistNeighborLoader``'s):
    edge_label_index: ``[2, E]`` seed edges, or ``(edge_type, [2, E])``
      on a typed graph.
    edge_label: optional ``[E]`` labels of the positives.
    neg_sampling: optional ``NegativeSampling`` ('binary' / 'triplet').
    neg_strict: valid negatives are then guaranteed non-edges.
  ``frontier_caps`` are calibrated at the per-shard seed width
  (``calibrate.link_seed_width``)."""

  def __init__(self, data: DistDataset, num_neighbors, edge_label_index,
               edge_label=None, batch_size: int = 64,
               shuffle: bool = False, drop_last: bool = True,
               neg_sampling=None, with_edge: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               node_budget: Optional[int] = None, mesh=None,
               with_weight: bool = False, dedup: str = 'sort',
               bucket_frac=2.0, neg_strict: bool = False,
               frontier_caps=None, overflow_policy: str = 'raise'):
    mesh = _mesh_or_context(mesh)
    input_type, edge_label_index = _split_edge_type(edge_label_index)
    ei = np.asarray(edge_label_index)
    self.seed_rows = ei[0].reshape(-1)
    self.seed_cols = ei[1].reshape(-1)
    self.edge_label = (np.asarray(edge_label).reshape(-1)
                       if edge_label is not None else None)
    self.neg_sampling = neg_sampling
    sampler = DistNeighborSampler(
        data.graph, num_neighbors, mesh,
        dist_feature=data.node_features, with_edge=with_edge, seed=seed,
        node_budget=node_budget, collect_features=collect_features,
        with_weight=with_weight, dedup=dedup, bucket_frac=bucket_frac,
        neg_strict=neg_strict, frontier_caps=frontier_caps)
    super().__init__(data, sampler, np.zeros(0, np.int64), batch_size,
                     shuffle, drop_last, collect_features, seed,
                     overflow_policy=overflow_policy)
    self.input_type = input_type   # the seed edge type on a typed graph

  def _num_seeds(self):
    return self.seed_rows.shape[0]

  def __iter__(self):
    guarded, recompute = self._overflow_epoch_start()
    for idx, mask in self._index_blocks():
      inputs = EdgeSamplerInput(
          self.seed_rows[idx], self.seed_cols[idx],
          label=(self.edge_label[idx]
                 if self.edge_label is not None else None),
          input_type=self.input_type, neg_sampling=self.neg_sampling)
      if recompute:
        keys = self.sampler._next_keys()
        out = self.sampler.sample_from_edges(inputs, seed_mask=mask,
                                             keys=keys)
        if self._batch_overflowed(out):
          self.overflow_recomputes += 1
          out = self._replay_sampler().sample_from_edges(
              inputs, seed_mask=mask, keys=keys)
      else:
        out = self.sampler.sample_from_edges(inputs, seed_mask=mask)
        if guarded:
          self._accumulate_overflow(out)
      yield self._collate_fn(out)
    if guarded and not recompute:
      self._finish_epoch_overflow()


class DistSubGraphLoader(DistLoader):
  """The distributed induced-subgraph loader
  (``DistNeighborSampler.subgraph``). ``num_neighbors=None`` induces over
  the seed set alone; otherwise the seeds are hop-expanded first."""

  def __init__(self, data: DistDataset, num_neighbors, input_nodes,
               batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = True, with_edge: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               max_degree: Optional[int] = None, mesh=None,
               bucket_frac=2.0):
    mesh = _mesh_or_context(mesh)
    sampler = DistNeighborSampler(
        data.graph, num_neighbors, mesh,
        dist_feature=data.node_features, with_edge=with_edge, seed=seed,
        collect_features=collect_features, bucket_frac=bucket_frac)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, collect_features, seed)
    self.max_degree = max_degree

  def __iter__(self):
    for idx, mask in self._index_blocks():
      out = self.sampler.subgraph(self.input_seeds[idx], seed_mask=mask,
                                  max_degree=self.max_degree)
      yield self._collate_fn(out)


class DistNeighborLoader(DistLoader):
  """The collocated distributed neighbour loader."""

  def __init__(self, data: DistDataset, num_neighbors: List[int],
               input_nodes, batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = True, with_edge: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               node_budget: Optional[int] = None, mesh=None,
               with_weight: bool = False, dedup: str = 'sort',
               seed_labels_only: bool = False, bucket_frac=2.0,
               frontier_caps=None, overflow_policy: str = 'raise'):
    mesh = _mesh_or_context(mesh)
    sampler = DistNeighborSampler(
        data.graph, num_neighbors, mesh,
        dist_feature=data.node_features, with_edge=with_edge, seed=seed,
        node_budget=node_budget, collect_features=collect_features,
        with_weight=with_weight, dedup=dedup, bucket_frac=bucket_frac,
        frontier_caps=frontier_caps)
    super().__init__(data, sampler, input_nodes, batch_size, shuffle,
                     drop_last, collect_features, seed,
                     seed_labels_only=seed_labels_only,
                     overflow_policy=overflow_policy)
