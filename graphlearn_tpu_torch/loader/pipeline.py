"""The fused epoch trainers' plumbing, and ``OverlappedTrainer``.

Counterpart of ``graphlearn_tpu/loader/pipeline.py``.
``FusedEpochTrainer`` holds the scope checks, the device feature and
label tables, and the sample+collate body an epoch trainer
(``loader.ScanTrainer``, ``loader.RunTrainer``, ``OverlappedTrainer``)
runs for every step. The JAX package traces that body into its programs.
Here it runs on the loader's device with no host step in it: it takes
the step's hop keys as a device tensor, reads nothing back and allocates
only by static shapes, so ``ScanTrainer`` can capture it into a CUDA
graph (or run it eagerly).

``OverlappedTrainer`` trains batch n while batch n+1 is sampled and
collated. JAX puts both in one program and leaves the overlap to XLA;
here the sampling runs on a second CUDA stream. Each epoch writes one
flight record (``metrics.flight``).

``DistFusedEpochTrainer`` is the distributed counterpart of
``FusedEpochTrainer`` (``graphlearn_tpu/loader/pipeline.py:267``): the
scope checks, the data-parallel step (:func:`data_parallel_step`: every
shard's loss, the gradients, loss and accuracy averaged over all P
shards, one optimizer step) and the per-shard sample-and-collate body
that ``loader.DistScanTrainer`` runs for every step, with the per-step
reference loop ``run_epoch_steps``; on a typed loader the body runs the
typed engine and one cached lookup per sampled, featured node type.
"""
from typing import Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..metrics import flight
from ..models import train as train_lib
from .link_loader import LinkLoader
from .node_loader import NodeLoader
from .subgraph_loader import SubGraphLoader

_RECOMPUTE_MSG = (
    "overflow_policy='recompute' needs a device->host sync per batch, "
    'which defeats the fused epoch. Use the plain loader loop for '
    "recompute, or overflow_policy='raise'/'warn' here (the flag "
    'accumulates on the device and is checked once at epoch end).')


class FusedEpochTrainer:
  """Scope validation, device tables and the sample+collate body.

  Requirements: a homogeneous ``NodeLoader`` over a device-resident
  feature table (no host part: ``Feature.device_table()`` is not None)
  with node labels, no edge features (supervised node classification,
  the JAX trainers' scope).
  """

  _NAME = 'FusedEpochTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               seed_labels_only: Optional[bool] = None):
    sampler = loader.sampler
    if getattr(sampler, 'is_hetero', False):
      # graftlint: allow[hetero-gate] local trainer is homo by design
      raise ValueError(f'{self._NAME} is homogeneous-only')
    if isinstance(loader, (LinkLoader, SubGraphLoader)):
      # link and subgraph batches carry what the node classification
      # step does not read (edge_label metadata, mappings): they train
      # in the per-step loop, as in JAX
      raise ValueError(f'{self._NAME} covers supervised node '
                       f'classification; {type(loader).__name__} batches '
                       'train in the per-step loop')
    if getattr(sampler, 'with_edge', False):
      raise ValueError('with_edge batches are not supported in the fused '
                       'epoch trainers')
    if getattr(sampler, 'clamped_exact', False) and \
        loader.overflow_policy == 'recompute':
      raise ValueError(_RECOMPUTE_MSG)
    self.loader = loader
    self.model = model
    self.num_classes = num_classes
    self._sampler = sampler
    self._batch_size = loader.batch_size
    if seed_labels_only is None:
      seed_labels_only = loader.seed_labels_only
    self._label_cap = self._batch_size if seed_labels_only else None
    self._feats, self._id2i = self._resolve_feature_tables(loader)
    self._labels = loader.data.node_labels
    if self._labels is None:
      raise ValueError(f'{self._NAME} needs node labels')
    self._train_step, _ = train_lib.make_train_step(model, num_classes)
    self._sample_collate = self._make_sample_collate_body()

  def _resolve_feature_tables(self, loader):
    """``(feats, id2index)``: the device tables the sample+collate body
    gathers from. Here an all-device table; the tiered trainer
    (``storage.TieredScanTrainer``) supplies a ``TieredFeature``'s hot
    prefix and gathers the rest from its staged slabs."""
    dt = (loader.data.node_features.device_table()
          if loader.data.node_features is not None else None)
    if dt is None:
      # a store with a host part is not read inside a captured chunk
      raise ValueError(f'{self._NAME} needs a device-resident '
                       'feature table (Feature on HBM), or the tiered '
                       'trainer (storage.TieredScanTrainer) for an '
                       'out-of-core TieredFeature')
    return dt

  def _make_sample_collate_body(self):
    """``(seeds, seed_mask, hop_keys) -> (batch, overflow)``: one batch
    sampled under the ``[n_hops, 2]`` device hop keys and collated on the
    device. The calibrated-caps overflow flag rides outside the batch
    dict (the train step does not see it)."""
    sampler, label_cap = self._sampler, self._label_cap
    feats, id2i, labels = self._feats, self._id2i, self._labels

    def _sample_collate(seeds, smask, hop_keys):
      res = sampler._sample(seeds, smask, hop_keys=hop_keys)
      col = ops.collate_batch(res['node'], res['num_nodes'], res['row'],
                              res['col'], feats, id2i, labels, None, None,
                              label_cap=label_cap)
      batch = dict(x=col['x'], edge_index=col['edge_index'],
                   edge_mask=res['edge_mask'], y=col['y'],
                   num_seed_nodes=res['num_sampled_nodes'][0])
      return batch, res['overflow']

    return _sample_collate


_DIST_REMOTE_MSG = (
    'scanned/fused distributed epochs are COLLOCATED-MESH only: pass a '
    'DistNeighborLoader over the training mesh. Remote (server-client) '
    'loaders have their own chunked path: distributed.RemoteScanTrainer, '
    'where the sampling servers replay the counter-addressed stream into '
    'K-batch blocks and the client trains one block per chunk')


def data_parallel_step(optimizer, loss_fn, shards, mesh):
  """One data-parallel optimizer step over this process's shard batches
  (JAX: per-shard gradients, ``lax.pmean`` over every mesh axis, one
  optax update): the backward of the local shards' losses summed over
  P (the gradient of the mean loss on a one-process mesh), the
  gradients summed over the process group (if any), one optimizer step.
  ``shards``: one batch dict per local shard; ``loss_fn(batch) -> (loss,
  acc)``. Returns the mean loss and accuracy over all P shards (0-d
  tensors, nothing read back)."""
  nparts = mesh.num_partitions
  optimizer.zero_grad()
  losses, accs = [], []
  for batch in shards:
    loss, acc = loss_fn(batch)
    losses.append(loss)
    accs.append(acc)
  total = torch.stack(losses).sum() / nparts
  total.backward()
  stats = torch.stack([total.detach(), torch.stack(accs).sum() / nparts])
  if mesh.group is not None:
    import torch.distributed as dist
    params = [p for g in optimizer.param_groups for p in g['params']]
    for p in params:
      if p.grad is not None:
        dist.all_reduce(p.grad, group=mesh.group)
    dist.all_reduce(stats, group=mesh.group)
  optimizer.step()
  return stats[0], stats[1]


def shard_batches(batch: dict):
  """A stacked ``[L, ...]`` batch dict (typed values: per-type dicts of
  ``[L, ...]``) -> one batch dict per local shard (``num_seed_nodes`` is
  ``[L]``)."""
  def pick(v, l):
    return {k: t[l] for k, t in v.items()} if isinstance(v, dict) else v[l]
  nloc = next(v.shape[0] for v in batch.values() if torch.is_tensor(v))
  return [{k: pick(v, l) for k, v in batch.items()} for l in range(nloc)]


class DistFusedEpochTrainer:
  """Scope validation, the data-parallel step and the per-shard
  sample+collate body of the distributed epoch trainers.

  Scope: a collocated homogeneous or typed ``DistNeighborLoader`` with
  feature collection, a ``DistFeature`` store (per node type on a typed
  loader) and node labels (of the seed type; supervised node
  classification on the mesh). Link and subgraph loaders,
  ``overflow_policy='recompute'``, ``with_edge`` and edge features are
  refused, as in JAX.
  """

  _NAME = 'DistFusedEpochTrainer'

  def __init__(self, loader, model, num_classes: int,
               seed_labels_only: Optional[bool] = None):
    from ..distributed.dist_loader import (DistLinkNeighborLoader,
                                           DistLoader, DistSubGraphLoader)
    if not isinstance(loader, DistLoader):
      raise ValueError(f'{self._NAME}: {type(loader).__name__} is not a '
                       f'collocated DistLoader. {_DIST_REMOTE_MSG}')
    if isinstance(loader, DistLinkNeighborLoader):
      raise ValueError(
          f'{self._NAME} covers supervised NODE classification; link '
          'loaders keep the per-step loop: link batches train on '
          'edge_label metadata the fused chunk does not collate')
    if isinstance(loader, DistSubGraphLoader):
      raise ValueError(
          f'{self._NAME} covers supervised NODE classification; '
          'subgraph loaders yield induced subgraphs with no train-step '
          'contract to fuse into a chunk: iterate them per step')
    if loader.overflow_policy == 'recompute':
      raise ValueError(_RECOMPUTE_MSG)
    sampler = loader.sampler
    if sampler.with_edge:
      raise ValueError('with_edge batches are not supported in the '
                       'fused distributed epoch programs')
    if getattr(loader.data, 'edge_features', None):
      raise ValueError(f'{self._NAME} does not collate edge features; '
                       'use the per-step loader loop')
    if not loader.collect_features or sampler.dist_feature is None:
      raise ValueError(f'{self._NAME} needs collect_features=True and a '
                       'DistFeature store (the fused program inlines the '
                       'cached miss-only lookup)')
    if loader.data.node_labels is None:
      raise ValueError(f'{self._NAME} needs node labels')
    self.loader = loader
    self.model = model
    self.num_classes = num_classes
    self._sampler = sampler
    self.is_hetero = sampler.is_hetero
    self.mesh = sampler.mesh
    self._nparts = loader.num_partitions
    self._batch_size = loader.batch_size    # per shard
    if seed_labels_only is None:
      seed_labels_only = loader.seed_labels_only
    self._label_cap = self._batch_size if seed_labels_only else None
    if self.is_hetero:
      self._input_type = loader.input_type
      assert self._input_type is not None, \
          'hetero distributed training requires typed seeds'
      labels = loader.data.node_labels
      if not isinstance(labels, dict) or self._input_type not in labels:
        raise ValueError(f'{self._NAME} needs labels for the seed type '
                         f'{self._input_type!r}')
      self._label_store = sampler._label_dist(labels[self._input_type],
                                              self._input_type)
      self._feat = dict(sampler.dist_feature)
    else:
      self._input_type = None
      self._label_store = sampler._label_dist(loader.data.node_labels)
      self._feat = sampler.dist_feature
    self._loss_fn = train_lib.make_loss_fn(model, num_classes)
    self._train_state_cls = train_lib.TrainState

  def _dp_step(self, state, shards):
    """The data-parallel update over per-shard batch dicts. Returns
    ``(state, loss, acc)``, the step count advanced."""
    loss, acc = data_parallel_step(state.optimizer, self._loss_fn, shards,
                                   self.mesh)
    return state._replace(step=state.step + 1), loss, acc

  def _make_sample_collate(self):
    """``(seeds [L, B], smask [L, B], hop_keys [L, hops, 2]) -> (batch,
    overflow, stats)``: the local shards' sample under device hop keys,
    then the cached feature lookup and the label gather, with no host
    read at ``bucket_frac=None``. ``batch`` holds ``[L, ...]`` tensors,
    ``overflow`` is the mesh-summed calibrated-caps flag (0-d),
    ``stats`` the feature store's ``[L, 4]`` counters of this lookup
    (JAX threads them through its scan carry; a ``{ntype: [L, 4]}`` dict
    on a typed loader)."""
    if self.is_hetero:
      return self._make_hetero_sample_collate()
    from ..distributed.dist_neighbor_sampler import _homo_hop_loop
    sampler, mesh = self._sampler, self.mesh
    b, label_cap = self._batch_size, self._label_cap
    fanouts = tuple(sampler.num_neighbors)
    caps = sampler._capacities(b)
    node_cap = sampler._node_cap(caps)
    gdev = sampler._dev
    weighted = sampler._weighted_for()
    feat, labels = self._feat, self._label_store
    tables = self._feature_tables

    def sample(seeds, smask, hop_keys):
      return _homo_hop_loop(mesh, gdev, gdev['node_pb'], seeds, smask,
                            None, fanouts, caps, node_cap, False, weighted,
                            dedup=sampler.dedup,
                            bucket_frac=sampler.bucket_frac,
                            hop_keys=hop_keys)

    self._sample = sample

    def body(seeds, smask, hop_keys):
      res = sample(seeds, smask, hop_keys)
      ids = res['node']
      x, stats = feat._lookup(ids, ids >= 0, tables=tables())
      lab_ids = ids[:, :label_cap] if label_cap is not None else ids
      y, _ = labels._lookup(lab_ids, lab_ids >= 0)
      batch = dict(x=x, edge_index=torch.stack([res['row'], res['col']], 1),
                   edge_mask=res['edge_mask'], y=y[..., 0],
                   num_seed_nodes=res['num_sampled_nodes'][:, 0])
      return batch, res['overflow'].any(), stats

    return body

  def _make_hetero_sample_collate(self):
    """The typed body (JAX's ``_make_hetero_sample_collate``): the typed
    engine under the ``[L, keys, 2]`` device keys, one cached lookup per
    sampled, featured node type (``self._feat_types``, each with its
    ``[L, 4]`` counters) and the seed type's labels."""
    sampler = self._sampler
    t_in, label_cap = self._input_type, self._label_cap
    plan = sampler._hetero_plan({t_in: self._batch_size})
    node_caps = plan[2]
    feat_types = [t for t in sampler.graph.ntypes
                  if node_caps.get(t, 0) > 0 and t in self._feat]
    self._feat_types = feat_types
    gdev = sampler._dev
    feats, labels = self._feat, self._label_store
    tables = self._feature_tables

    def sample(seeds, smask, hop_keys):
      res, _ = sampler._hetero_engine(gdev, gdev['#pb'],
                                      {t_in: (seeds, smask)}, hop_keys, plan)
      return res

    self._sample = sample

    def body(seeds, smask, hop_keys):
      res = sample(seeds, smask, hop_keys)
      x, stats = {}, {}
      for t in feat_types:
        ids = res['node'][t]
        x[t], stats[t] = feats[t]._lookup(ids, ids >= 0, tables=tables(t))
      ids = res['node'][t_in]
      lab_ids = ids[:, :label_cap] if label_cap is not None else ids
      y, _ = labels._lookup(lab_ids, lab_ids >= 0)
      ei = {et: torch.stack([res['row'][et], res['col'][et]], 1)
            for et in res['row']}
      batch = dict(x=x, edge_index=ei, edge_mask=res['edge_mask'],
                   y=y[..., 0],
                   num_seed_nodes=res['num_sampled_nodes'][t_in][:, 0])
      return batch, res['overflow'].any(), stats

    return body

  def _feature_tables(self, ntype=None):
    """The device tables the feature lookup (of ``ntype`` on a typed
    loader) reads (None: the store's own ``device_arrays``; the tiered
    trainer's hot prefix and static slab)."""
    return None

  # ------------------------------------------------- per-step reference

  def train_step(self, state, batch):
    """One data-parallel optimizer update from a collocated dist batch
    (the loader's stacked ``Data``). Returns ``(state, loss, acc)``,
    loss and acc as 0-d device tensors (the mean over all P shards)."""
    if self.is_hetero:
      y = batch.y[self._input_type]
      nseed = batch.num_sampled_nodes[self._input_type][:, 0]
    else:
      y, nseed = batch.y, batch.num_sampled_nodes[:, 0]
    stacked = dict(x=batch.x, edge_index=batch.edge_index,
                   edge_mask=batch.edge_mask, y=y, num_seed_nodes=nseed)
    return self._dp_step(state, shard_batches(stacked))

  def run_epoch_steps(self, state, max_steps: Optional[int] = None):
    """The per-step reference epoch: iterate the collocated loader and
    apply the data-parallel step per batch, the loop a shuffle=False
    scanned epoch replays. Returns ``(state, losses)``, ``losses`` a
    list of 0-d device tensors."""
    losses = []
    for batch in self.loader:
      state, loss, _ = self.train_step(state, batch)
      losses.append(loss)
      if max_steps is not None and len(losses) >= max_steps:
        break
    return state, losses


class OverlappedTrainer(FusedEpochTrainer):
  """Trains batch n on the caller's stream while batch n+1 is sampled and
  collated on a second stream (on a card; the CPU runs them in turn, with
  the same results).

  Per epoch: the prime batch, then for every further seed batch its
  sample and collate, then the train step of the batch before it; at the
  epoch's natural end the last batch trains with a plain step. Each batch
  takes ``sampler._next_key()``, in the per-step loop's order, so the
  losses are the loop's. A batch's overflow flag joins the epoch's only
  when the batch trains: ``max_steps`` drops the pending batch (exactly
  ``max_steps`` updates) and its flag with it. The flag is checked at
  the epoch's natural end; ``overflow_policy='recompute'`` is refused.

  On a card, the side stream waits for the caller's stream at the epoch's
  start and the caller's for it at the end; each batch's tensors are
  handed over by an event and ``record_stream``. The sampler's scratch is
  used by sampling alone, all on the side stream, and collate allocates
  fresh outputs, so batch n+1 writes nothing batch n's step reads. Seeds,
  masks and hop keys go up from pinned memory without blocking the host.
  """

  _NAME = 'OverlappedTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               seed_labels_only: Optional[bool] = None):
    super().__init__(loader, model, num_classes, seed_labels_only)
    self._n_hops = len(self._sampler.num_neighbors)
    self._side = None   # the sampling stream, on a card

  def _seed_batches(self):
    for idx in self.loader._batcher:
      seeds = self.loader.input_seeds[idx]
      n = seeds.shape[0]
      padded = np.zeros((self._batch_size,), np.int32)
      padded[:n] = seeds
      yield padded, np.arange(self._batch_size) < n

  def _prefetch(self, padded, mask):
    """``(batch, overflow flag, ready event)`` of one seed batch under the
    sampler's next key, sampled and collated on the side stream (the
    event is None on the CPU)."""
    device = self.loader.device
    keys = trandom.split(self._sampler._next_key(), self._n_hops)
    seeds, smask = torch.from_numpy(padded), torch.from_numpy(mask)
    if device.type != 'cuda':
      return (*self._sample_collate(seeds, smask, keys), None)
    with torch.cuda.stream(self._side):
      seeds = seeds.pin_memory().to(device, non_blocking=True)
      smask = smask.pin_memory().to(device, non_blocking=True)
      batch, pending = self._sample_collate(
          seeds, smask, trandom.to_device(keys, device))
      ready = torch.cuda.Event()
      ready.record(self._side)
    return batch, pending, ready

  def _train(self, state, batch, pending, ready):
    """The train step of a prefetched batch, on the caller's stream."""
    if ready is not None:
      main = torch.cuda.current_stream(self.loader.device)
      main.wait_event(ready)
      for t in (*batch.values(), pending):
        if torch.is_tensor(t):
          t.record_stream(main)
    state, loss, _ = self._train_step(state, batch)
    return state, loss

  def run_epoch(self, state, max_steps: Optional[int] = None):
    """One epoch of overlapped steps. Returns ``(state, losses)``,
    ``losses`` a list of 0-d device tensors (one per step): read them
    after the epoch."""
    guarded, recompute = self.loader._overflow_epoch_start()
    if recompute:
      raise ValueError(_RECOMPUTE_MSG)
    # the batches bypass NodeLoader.__iter__, so the padded-table reseed
    # is driven here, on the caller's stream, before the side stream
    # waits for it (after the refusal: a refused epoch reseeds nothing)
    self.loader._begin_epoch()
    device = self.loader.device
    main = None
    if device.type == 'cuda':
      main = torch.cuda.current_stream(device)
      if self._side is None:
        self._side = torch.cuda.Stream(device)
      self._side.wait_stream(main)
    flight_tok = flight.epoch_begin()
    losses, truncated, completed = [], False, False
    batch = pending = ready = None
    try:
      # inside the bracket, as JAX's: a failed allocation still closes
      # the epoch's flight record
      ovf = torch.zeros((), dtype=torch.bool, device=device)  # trained ones'
      try:
        for padded, mask in self._seed_batches():
          nxt = self._prefetch(padded, mask)
          if batch is not None:
            state, loss = self._train(state, batch, pending, ready)
            ovf = ovf | pending
            losses.append(loss)
          batch, pending, ready = nxt
          if max_steps is not None and losses and len(losses) >= max_steps:
            truncated = True   # the pending batch is dropped, flag and all
            break
        if batch is not None and not truncated:
          state, loss = self._train(state, batch, pending, ready)
          ovf = ovf | pending
          losses.append(loss)
      finally:
        if main is not None:
          main.wait_stream(self._side)
      completed = True
      if guarded:
        self.loader._ovf_accum = ovf
        if not truncated:
          self.loader._finish_epoch_overflow()
    finally:
      # per-epoch flight record — host deltas only; a mid-epoch failure
      # still records, with completed=False
      flight.end_for(
          self, flight_tok, emitter=self._NAME, steps=len(losses),
          completed=completed,
          config=dict(trainer=self._NAME, batch_size=self._batch_size,
                      fanouts=list(self._sampler.num_neighbors),
                      num_classes=self.num_classes,
                      seed=self.loader._batcher.seed),
          extra={'truncated': truncated})
    return state, losses
