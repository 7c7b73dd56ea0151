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
subgraphs.

The multiprocess loaders (``MpDistNeighborLoader``,
``MpDistLinkNeighborLoader``: sampling worker processes on the dataset's
device feeding a shared-memory ring) and the remote ones
(``RemoteDistNeighborLoader``, ``RemoteDistLinkNeighborLoader``: batches
pulled from ``DistServer`` producers over the RPC, with heartbeats and
the failover of a dead server's unacked seeds) follow.

Every loader's epoch writes one flight record (``metrics.flight``) and
one ``epoch.run`` span; a collocated loader publishes its stores' hit /
miss counters (``DistFeature.publish_stats``) once per epoch before its
record, so the record's ``feature`` fields are the published counters.
"""
import logging
import time
from typing import List, Optional

import numpy as np

from .. import ops
from ..loader.node_loader import OverflowGuardMixin
from ..metrics import flight, spans
from ..loader.transform import Data, HeteroData
from ..sampler import EdgeSamplerInput, HeteroSamplerOutput, NodeSamplerInput
from ..typing import reverse_edge_type
from ..typing import split_edge_type_seeds as _split_edge_type
from .dist_dataset import DistDataset
from .dist_neighbor_sampler import DistNeighborSampler
from .tenancy import with_backpressure
from ..utils import resolve_device, step_annotation, trace

logger = logging.getLogger('graphlearn_tpu_torch.loader')


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

  # every per-step loader epoch appends ONE flight record to
  # GLT_RUN_LOG and one epoch.run span: host bookkeeping around the
  # loop (the feature fields come from the epoch's one publish_stats
  # read)

  def _flight_begin(self):
    # both carry the process run_id, so a flight line, a scrape and the
    # epoch's span tree join on one id
    return (flight.epoch_begin(),
            spans.begin('epoch.run', emitter=type(self).__name__))

  def _flight_end(self, tok, steps: int, completed: bool):
    flight_tok, span_tok = tok
    spans.end(span_tok, steps=steps, completed=completed)
    flight.end_for(self, flight_tok, steps=steps, completed=completed,
                   config=self._flight_config())

  def _flight_config(self) -> dict:
    """Static epoch configuration (fingerprinted in flight records)."""
    return dict(loader=type(self).__name__, batch_size=self.batch_size,
                shuffle=self.shuffle, drop_last=self.drop_last,
                num_partitions=self.num_partitions, seed=self.seed,
                num_neighbors=getattr(self.sampler, 'num_neighbors',
                                      None))

  def _publish_feature_stats(self):
    """Move the stores' hit / miss counters into the registry once per
    epoch (one device read each): the node and edge feature stores under
    ``dist_feature``, the sampler's label stores under ``dist_label``.
    Each accumulator is drained every epoch, as in JAX."""
    for f in self.data.feature_stores():
      f.publish_stats()
    for f in self.sampler.label_stores():
      f.publish_stats(prefix='dist_label')

  def __iter__(self):
    # overflow-policy state resolves BEFORE the span/flight bracket: a
    # raise from it must not leak the attached epoch.run span
    guarded, recompute = self._overflow_epoch_start()
    tok = self._flight_begin()
    steps, completed = 0, False
    try:
      for i, (idx, mask) in enumerate(self._index_blocks()):
        with step_annotation('glt_dist_batch', i):
          inp = NodeSamplerInput(self.input_seeds[idx], self.input_type)
          if recompute:
            keys = self.sampler._next_keys()
            out = self.sampler.sample_from_nodes(inp, seed_mask=mask,
                                                 keys=keys)
            if self._batch_overflowed(out):
              self.overflow_recomputes += 1
              out = self._replay_sampler().sample_from_nodes(
                  inp, seed_mask=mask, keys=keys)
          else:
            out = self.sampler.sample_from_nodes(inp, seed_mask=mask)
            if guarded:
              self._accumulate_overflow(out)
          batch = self._collate_fn(out)
        yield batch
        steps += 1
      completed = True
      if guarded and not recompute:
        self._finish_epoch_overflow()
    finally:
      # also on early break/close: the accumulator is drained per epoch.
      # The publish reads the card and can raise — the span/flight close
      # must survive it, or the attached epoch span leaks
      try:
        self._publish_feature_stats()
      finally:
        self._flight_end(tok, steps, completed)

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
    tok = self._flight_begin()
    steps, completed = 0, False
    try:
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
        steps += 1
      completed = True
      if guarded and not recompute:
        self._finish_epoch_overflow()
    finally:
      try:
        self._publish_feature_stats()
      finally:
        self._flight_end(tok, steps, completed)


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
    tok = self._flight_begin()
    steps, completed = 0, False
    try:
      for idx, mask in self._index_blocks():
        out = self.sampler.subgraph(self.input_seeds[idx], seed_mask=mask,
                                    max_degree=self.max_degree)
        yield self._collate_fn(out)
        steps += 1
      completed = True
    finally:
      try:
        self._publish_feature_stats()
      finally:
        self._flight_end(tok, steps, completed)


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


def _norm_num_neighbors(num_neighbors):
  """Picklable copy: per-etype dict fanouts or a shared list."""
  return (dict(num_neighbors) if isinstance(num_neighbors, dict)
          else list(num_neighbors))


class MpDistNeighborLoader:
  """Mp worker mode: sampling processes feed a shared-memory channel and
  the loader drains it (JAX's ``MpDistNeighborLoader``). The workers
  sample on the dataset's device; ``device`` (the port's trailing
  argument) is where the loader's batches go, by default the dataset's
  device. Typed seeds as ``('ntype', ids)``."""

  def __init__(self, data, num_neighbors, input_nodes,
               batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, num_workers: int = 2,
               channel_size: int = 1 << 26, seed: Optional[int] = None,
               max_worker_restarts: int = 2, device=None):
    from ..sampler import SamplingConfig, SamplingType
    input_type, input_nodes = _split_input_type(input_nodes)
    config = SamplingConfig(
        SamplingType.NODE, _norm_num_neighbors(num_neighbors),
        batch_size, shuffle, drop_last, with_edge, collect_features,
        False, False, data.edge_dir, seed)
    self._setup(data,
                NodeSamplerInput(np.asarray(input_nodes).reshape(-1),
                                 input_type=input_type),
                config, channel_size, num_workers, seed,
                max_worker_restarts=max_worker_restarts, device=device)

  def _setup(self, data, sampler_input, config, channel_size, num_workers,
             seed, max_worker_restarts: int = 2, device=None):
    """Shared producer/channel wiring for the mp loader family."""
    from ..channel import ShmChannel
    from .dist_sampling_producer import DistMpSamplingProducer
    self.device = data.device if device is None else resolve_device(device)
    self.channel = ShmChannel(shm_size=channel_size)
    try:
      self.producer = DistMpSamplingProducer(
          data, sampler_input, config, self.channel,
          num_workers=num_workers, seed=seed,
          max_worker_restarts=max_worker_restarts)
      self.producer.init()
    except BaseException:
      self.channel.close()
      raise
    self._expected = self.producer.num_expected()
    # recv window between producer health checks: short enough that a
    # crashed worker is detected (and restarted) promptly, long enough
    # that the checks stay off the hot path
    self.health_check_interval_ms = 5000

  def __len__(self):
    return self._expected

  def __iter__(self):
    from ..channel import QueueTimeoutError
    from .message import message_to_data
    cfg = self.producer.config
    tok = flight.epoch_begin()
    # the epoch span is CURRENT while produce_all ships the epoch
    # commands, so the workers' spans (producer.epoch/batch) parent under
    # it; produce_all runs INSIDE the try — a raise there must still end
    # the attached span
    sp = spans.begin('epoch.run', emitter=type(self).__name__)
    received = 0
    try:
      self.producer.produce_all()
      while received < self._expected:
        try:
          msg = self.channel.recv(timeout_ms=self.health_check_interval_ms)
        except QueueTimeoutError:
          # crashed worker -> restart + bit-identical replay (raises only
          # once the restart budget is exhausted), rather than spinning
          # on an empty channel forever
          self.producer.check_worker_health()
          if self.producer.is_all_sampling_completed() and \
              self.channel.empty():
            break
          continue
        received += 1
        yield message_to_data(msg, device=self.device)
    finally:
      spans.end(sp, steps=received,
                completed=received >= self._expected)
      flight.end_for(
          self, tok, steps=received,
          completed=received >= self._expected,
          config=dict(loader=type(self).__name__,
                      batch_size=cfg.batch_size, shuffle=cfg.shuffle,
                      num_neighbors=cfg.num_neighbors,
                      num_workers=self.producer.num_workers))

  def worker_metrics(self):
    """Merged metric snapshot across this loader's sampling workers (see
    ``DistMpSamplingProducer.worker_metrics``); None before the first
    epoch-end publish."""
    return self.producer.worker_metrics()

  def shutdown(self):
    self.producer.shutdown()
    self.channel.close()


class MpDistLinkNeighborLoader(MpDistNeighborLoader):
  """Mp worker mode for LINK sampling: the workers run
  ``sample_from_edges`` (positives and negatives) and stream batches
  with ``edge_label_index`` / ``edge_label`` metadata. Typed seed edges
  as ``((src, rel, dst), [2, E])``."""

  def __init__(self, data, num_neighbors: List[int], edge_label_index,
               edge_label=None, neg_sampling=None, batch_size: int = 64,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, collect_features: bool = True,
               num_workers: int = 2, channel_size: int = 1 << 26,
               seed: Optional[int] = None, device=None):
    from ..sampler import SamplingConfig, SamplingType
    edge_type, edge_label_index = _split_edge_type(edge_label_index)
    ei = np.asarray(edge_label_index)
    config = SamplingConfig(
        SamplingType.LINK, _norm_num_neighbors(num_neighbors),
        batch_size, shuffle, drop_last, with_edge, collect_features,
        neg_sampling is not None, False, data.edge_dir, seed)
    self._setup(data,
                EdgeSamplerInput(ei[0], ei[1], label=edge_label,
                                 input_type=edge_type,
                                 neg_sampling=neg_sampling),
                config, channel_size, num_workers, seed, device=device)


class _RemoteLoaderBase:
  """Shared remote (server-client) machinery: one producer per server
  from a per-server split of the sampler input, batches pulled through
  the ``RemoteReceivingChannel``, producers restarted per epoch.

  Resilience: a ``Heartbeat`` thread per server detects death in about
  ``heartbeat_interval * heartbeat_miss`` seconds; a dead server's
  UNACKED seeds — its seed share minus the seeds of batches this loader
  already received (each batch message carries its seed ids in
  'batch') — are redistributed across the surviving servers as fresh
  producers, so the epoch completes with every seed delivered exactly
  once. The server's idempotent ``worker_key`` makes the re-requests
  safe. Degradations are counted by ``utils.trace`` counters
  (``resilience.failover``, ``resilience.failover_seeds``,
  ``resilience.server_dead``).
  """

  #: Node loaders ack received seeds from each batch's 'batch' ids and
  #: can therefore fail over; link batches carry only local indices, so
  #: the link loader degrades to a hard error on server death.
  supports_failover = True

  def _tenant_kwargs(self) -> dict:
    """``create_sampling_producer`` keywords registering this loader's
    producers under its tenant; empty (and understood by a server
    without tenancy) when no tenant is configured."""
    if getattr(self, '_tenant', None) is None:
      return {}
    return dict(tenant=self._tenant, priority=self._tenant_priority,
                weight=self._tenant_weight)

  def _note_throttle(self, rej):
    # remembered so that an idle-budget QueueTimeoutError names the
    # quota this tenant last bounced off
    self._last_throttle = rej

  def _setup_remote(self, config, per_server_inputs, worker_options,
                    device=None):
    import dataclasses

    from ..channel import RemoteReceivingChannel
    from ..utils import parse_size
    from . import dist_client
    from .resilience import Heartbeat
    opts = worker_options
    self.device = resolve_device(device)
    self._opts = opts
    self._config = config
    self._tenant = getattr(opts, 'tenant', None) if opts else None
    self._tenant_priority = (getattr(opts, 'tenant_priority', None)
                             if opts else None)
    self._tenant_weight = (getattr(opts, 'tenant_weight', None)
                           if opts else None)
    self._bp_budget = (getattr(opts, 'backpressure_budget', 120.0)
                       if opts else 120.0)
    self._last_throttle = None   # the last TenantRejection, for context
    # the server's ring per producer: JAX's option, which JAX's loader
    # leaves at the server's 64 MiB default; a full-width batch needs more
    self._create_kw = {}
    if opts is not None and opts.buffer_size is not None:
      self._create_kw['buffer_size'] = (
          parse_size(opts.buffer_size) if isinstance(opts.buffer_size, str)
          else int(opts.buffer_size))
    self.producer_ids = []
    self._expected = 0
    self._pair_expected = {}
    for i, (rank, part) in enumerate(zip(self.server_ranks,
                                         per_server_inputs)):
      # fold the SERVER index into the seed: same-ranked workers on
      # different servers would otherwise derive identical worker seeds
      cfg_i = dataclasses.replace(
          config, seed=(config.seed or 0) * 7919 + i)
      pid = with_backpressure(
          lambda rank=rank, part=part, cfg_i=cfg_i:
          dist_client.request_server(
              rank, 'create_sampling_producer', part, cfg_i,
              opts.num_workers if opts else 1,
              worker_key=(opts.worker_key if opts else None),
              **self._create_kw, **self._tenant_kwargs()),
          describe=f'create_sampling_producer rank {rank}',
          budget_s=self._bp_budget, tenant=self._tenant,
          on_reject=self._note_throttle)
      self.producer_ids.append(pid)
      # the producer's own count: its workers split the seed share and
      # each rounds up, so ceil(n / batch_size) would undercount here
      exp = dist_client.request_server(
          rank, 'producer_num_expected', pid, idempotent=True)
      self._pair_expected[(rank, pid)] = exp
      self._expected += exp
    self.channel = RemoteReceivingChannel(
        self.server_ranks, self.producer_ids,
        prefetch_size=(opts.prefetch_size if opts else 4))
    self._dist_client = dist_client
    # per-(rank, pid) seed shares for failover accounting (None when the
    # input carries no ackable seeds: link mode)
    self._pair_parts = {}
    for rank, pid, part in zip(self.server_ranks, self.producer_ids,
                               per_server_inputs):
      seeds = getattr(part, 'node', part if not hasattr(part, 'row')
                      else None)
      self._pair_parts[(rank, pid)] = (
          np.asarray(seeds).reshape(-1) if seeds is not None else None)
    self._dead_ranks = {}        # rank -> cause, sticky across epochs
    self._pair_batches = {}      # (rank, pid) -> batches received
    self._live_pairs = set()     # this epoch's pulling (rank, pid)s
    self._fo_producers = []      # this epoch's replacement (rank, pid)s
    self._fo_seq = 0
    self._epoch = 0
    self._heartbeat_miss = opts.heartbeat_miss if opts else 3
    self._heartbeat_interval = opts.heartbeat_interval if opts else 1.0
    self._failover_enabled = (opts.failover if opts else True) and \
        self.supports_failover
    self._idle_budget = opts.rpc_timeout if opts else 180.0
    probe_timeout = max(self._heartbeat_interval, 2.0)

    def probe(rank):
      from .resilience import NO_RETRY
      dist_client.request_server(rank, 'heartbeat',
                                 timeout=probe_timeout,
                                 idempotent=True, retry_policy=NO_RETRY)

    self._heartbeat = Heartbeat(
        self.server_ranks, probe, interval=self._heartbeat_interval,
        miss_threshold=self._heartbeat_miss)

  def _resolve_ranks(self, worker_options):
    opts = worker_options
    ranks = opts.server_rank if opts and opts.server_rank is not None \
        else [0]
    if isinstance(ranks, int):
      ranks = [ranks]
    self.server_ranks = list(ranks)

  def __len__(self):
    return self._expected

  # -- failover machinery ---------------------------------------------------

  def _ack(self, rank, pid, msg):
    """Record which seeds a received batch covered (homogeneous: 'batch'
    ids; typed: 'batch.<input_type>'). Unackable messages are ignored —
    failover then treats their seeds as undelivered (safe: the pair's
    producer is abandoned before replay)."""
    self._pair_batches[(rank, pid)] = \
        self._pair_batches.get((rank, pid), 0) + 1
    acked = self._acked.get((rank, pid))
    if acked is None:
      acked = self._acked[(rank, pid)] = set()
    bs = msg.get('#META.batch_size')
    ids = msg.get('batch')
    if ids is None and '#META.input_type' in msg:
      t = bytes(np.asarray(msg['#META.input_type'])).decode()
      ids = msg.get(f'batch.{t}')
    if ids is None:
      return
    ids = np.asarray(ids).reshape(-1)
    if bs is not None:
      ids = ids[:int(np.asarray(bs).reshape(-1)[0])]
    acked.update(int(i) for i in ids)

  def _handle_dead_pair(self, rank, pid, cause):
    """Declare (rank, pid) dead and redistribute its unacked seeds to
    surviving servers. Returns buffered messages drained while
    abandoning the pair (already acked; the caller yields them).
    Idempotent per pair per epoch."""
    if (rank, pid) in self._handled_pairs:
      return []
    # feasibility FIRST, before any state changes: a loader that cannot
    # fail over must not mark the rank sticky-dead
    part = self._pair_parts.get((rank, pid))
    if not self.supports_failover or part is None:
      raise RuntimeError(
          f'sampling server rank {rank} died mid-epoch ({cause}) and '
          'this loader cannot fail over: its batches carry no seed '
          'provenance to ack (link mode) — restart the epoch')
    if not self._failover_enabled:
      raise RuntimeError(
          f'sampling server rank {rank} died mid-epoch ({cause}) and '
          'failover is disabled (RemoteDistSamplingWorkerOptions'
          '.failover=False)')
    self._handled_pairs.add((rank, pid))
    # the failover span is the epoch tree's resilience annotation: the
    # dead rank, its cause and the redistributed seed count hang off the
    # epoch's epoch.run span, and the replacement producers' RPCs parent
    # under it
    fo_span = spans.begin('loader.failover', rank=rank,
                          cause=str(cause)[:200])
    try:
      return self._handle_dead_pair_spanned(rank, pid, cause, part,
                                            fo_span)
    except BaseException as e:
      fo_span.attrs['error'] = f'{type(e).__name__}: {e}'
      raise
    finally:
      spans.end(fo_span)

  def _handle_dead_pair_spanned(self, rank, pid, cause, part, fo_span):
    self._live_pairs.discard((rank, pid))
    self._dead_ranks[rank] = cause
    self._heartbeat.mark_dead(rank, cause)
    self.channel.abandon(rank, pid)
    # ack everything already buffered from ANY pair before computing the
    # unacked set — in-flight batches of the dying server must not be
    # re-requested (they were delivered, just not consumed yet)
    buffered = self.channel.drain_now()
    for r2, p2, m in buffered:
      self._ack(r2, p2, m)
    acked = self._acked.get((rank, pid), set())
    unacked = part[~np.isin(part, np.fromiter(acked, dtype=part.dtype,
                                              count=len(acked)))] \
        if len(acked) else part
    survivors = [r for r in self.server_ranks
                 if r not in self._dead_ranks]
    if not survivors:
      raise RuntimeError(
          f'all sampling servers dead (last: rank {rank}: {cause}) — '
          'cannot complete the epoch')
    trace.counter_inc('resilience.failover')
    trace.counter_inc('resilience.failover_seeds', int(unacked.shape[0]))
    fo_span.attrs.update(seeds=int(unacked.shape[0]),
                         survivors=list(survivors))
    logger.warning(
        'server rank %d dead (%s): redistributing %d unacked seeds '
        'across surviving servers %s', rank, cause, unacked.shape[0],
        survivors)
    if unacked.shape[0] == 0:
      return buffered
    import dataclasses
    new_expected = 0
    splits = np.array_split(unacked, len(survivors))
    for r2, sub in zip(survivors, splits):
      if sub.shape[0] == 0:
        continue
      self._fo_seq += 1
      base_key = (self._opts.worker_key
                  if self._opts and self._opts.worker_key else 'fo')
      key = (f'{base_key}/fo/e{self._epoch}/'
             f'd{rank}/s{r2}/{self._fo_seq}')
      part2 = (NodeSamplerInput(sub, self.input_type)
               if getattr(self, 'input_type', None) is not None else sub)
      cfg2 = dataclasses.replace(
          self._config,
          seed=(self._config.seed or 0) * 7919 + 104729 + self._fo_seq)
      # worker_key makes the create re-request-safe, so it may retry;
      # start_new_epoch_sampling has no such dedup and stays
      # single-attempt
      pid2 = with_backpressure(
          lambda r2=r2, part2=part2, cfg2=cfg2, key=key:
          self._dist_client.request_server(
              r2, 'create_sampling_producer', part2, cfg2,
              self._opts.num_workers if self._opts else 1, worker_key=key,
              idempotent=True, **self._create_kw, **self._tenant_kwargs()),
          describe=f'failover producer rank {r2}',
          budget_s=self._bp_budget, tenant=self._tenant,
          on_reject=self._note_throttle)
      repl_expected = self._dist_client.request_server(
          r2, 'producer_num_expected', pid2, idempotent=True)
      self._dist_client.request_server(r2, 'start_new_epoch_sampling',
                                       pid2)
      self._pair_parts[(r2, pid2)] = sub
      self._pair_expected[(r2, pid2)] = repl_expected
      self._fo_producers.append((r2, pid2))
      self._live_pairs.add((r2, pid2))
      self.channel.add_producer(r2, pid2)
      new_expected += repl_expected
    # keep len(self) truthful mid-epoch: this epoch now delivers the
    # dead pair's already-received batches + the replacements' counts
    dead_expected = self._pair_expected.get((rank, pid))
    if dead_expected is not None:
      delivered = self._pair_batches.get((rank, pid), 0)
      self._expected += new_expected - (dead_expected - delivered)
    return buffered

  def __iter__(self):
    # Ordering matters: kill any previous epoch's pullers BEFORE
    # restarting the server producers (a stale puller would consume
    # new-epoch messages into its dead queue), and only then start the
    # new pullers.
    self.channel.stop(join=True)
    self._epoch += 1
    cfg = self._config
    tok = flight.epoch_begin()
    # the epoch span stays current across _epoch_messages, so the
    # start_new_epoch_sampling RPCs (and through them the servers'
    # producer workers) and any failover spans parent under it — one
    # joinable tree per epoch across client, server and producers
    sp = spans.begin('epoch.run', emitter=type(self).__name__,
                     epoch=self._epoch)
    received, completed = 0, False
    try:
      for data in self._epoch_messages():
        yield data
        received += 1
      completed = True
    finally:
      spans.end(sp, steps=received, completed=completed,
                dead_ranks=len(self._dead_ranks))
      # the epoch's postmortem trail: failover / retry counter deltas,
      # batches delivered, wall — nothing on the hot path
      flight.end_for(
          self, tok, epoch=self._epoch, steps=received,
          completed=completed,
          config=dict(loader=type(self).__name__,
                      batch_size=cfg.batch_size, shuffle=cfg.shuffle,
                      num_neighbors=cfg.num_neighbors,
                      servers=list(self.server_ranks)),
          extra={'expected': self._expected,
                 'dead_ranks': {str(r): c for r, c in
                                self._dead_ranks.items()}})

  def _to_data(self, msg):
    from .message import message_to_data
    return message_to_data(msg, device=self.device)

  def _epoch_messages(self):
    from ..channel import QueueTimeoutError
    from ..channel.remote_channel import PeerDeadError
    self._acked = {}
    self._pair_batches = {}
    self._handled_pairs = set()
    # failover producers are per-epoch: release last epoch's now (and
    # drop their seed-share records)
    for rank, pid in self._fo_producers:
      self._pair_parts.pop((rank, pid), None)
      self._pair_expected.pop((rank, pid), None)
      try:
        self._dist_client.request_server(rank,
                                         'destroy_sampling_producer', pid)
      except (RuntimeError, ConnectionError, OSError):
        pass
    self._fo_producers = []
    # restore the undegraded expectation; this epoch's failovers (if
    # any) re-adjust it as they happen
    self._expected = sum(
        self._pair_expected.get(p, 0)
        for p in zip(self.server_ranks, self.producer_ids))
    started, start_dead = [], []
    for rank, pid in zip(self.server_ranks, self.producer_ids):
      if rank in self._dead_ranks:
        start_dead.append((rank, pid))
        continue
      try:
        self._dist_client.request_server(rank, 'start_new_epoch_sampling',
                                         pid)
        started.append((rank, pid))
      except (ConnectionError, TimeoutError, OSError) as e:
        if not (self._failover_enabled and self.supports_failover):
          raise
        start_dead.append((rank, pid))
        self._dead_ranks[rank] = repr(e)
    if not started:
      raise RuntimeError('no live sampling server to start the epoch: '
                         f'dead={self._dead_ranks}')
    self._live_pairs = set(started)
    self.channel.start_pairs(started)
    self._heartbeat.start()
    # ranks that died in an earlier epoch (or refused the epoch start):
    # their whole seed share is unacked — fail it over immediately
    for rank, pid in start_dead:
      for r2, p2, m in self._handle_dead_pair(
          rank, pid, self._dead_ranks.get(rank, 'dead at epoch start')):
        yield self._to_data(m)
    idle_since = time.monotonic()
    while True:
      try:
        rank, pid, msg = self.channel.recv_with_meta(timeout_ms=5000)
      except StopIteration:
        return
      except PeerDeadError as e:
        for r2, p2, m in self._handle_dead_pair(e.rank, e.producer_id,
                                                e.cause):
          yield self._to_data(m)
        continue
      except QueueTimeoutError as qte:
        # quiet window: consult liveness before waiting further — a
        # partitioned or hung server never RSTs, the heartbeat is the
        # only signal
        handled = False
        for rank, cause in self._heartbeat.dead_ranks().items():
          for (r2, p2) in [pr for pr in list(self._live_pairs)
                           if pr[0] == rank and
                           pr not in self._handled_pairs]:
            for r3, p3, m in self._handle_dead_pair(r2, p2, cause):
              yield self._to_data(m)
            handled = True
        if handled:
          idle_since = time.monotonic()
          continue
        if time.monotonic() - idle_since > self._idle_budget:
          # a starved tenant's stall names who hit which limit
          last = self._last_throttle
          qte.with_context(tenant=self._tenant,
                           quota=getattr(last, 'quota', None))
          raise
        continue
      idle_since = time.monotonic()
      self._ack(rank, pid, msg)
      yield self._to_data(msg)

  def shutdown(self):
    self._heartbeat.stop()
    self.channel.stop(join=True)
    for rank, pid in (list(zip(self.server_ranks, self.producer_ids)) +
                      list(self._fo_producers)):
      if rank in self._dead_ranks:
        continue
      try:
        self._dist_client.request_server(rank,
                                         'destroy_sampling_producer', pid)
      except (RuntimeError, ConnectionError, OSError):
        pass


class RemoteDistNeighborLoader(_RemoteLoaderBase):
  """Remote (server-client) NODE loading: producers run on the sampling
  servers, batches stream back over the RPC; typed seeds as
  ``('ntype', ids)``. ``device`` (the port's trailing argument; None
  means the card) is where the batches go."""

  def __init__(self, num_neighbors, input_nodes,
               batch_size: int = 64, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, worker_options=None,
               seed: Optional[int] = None, device=None):
    from ..sampler import SamplingConfig, SamplingType
    self._resolve_ranks(worker_options)
    input_type, input_nodes = _split_input_type(input_nodes)
    # kept for failover: replacement producers re-ship TYPED seeds
    self.input_type = input_type
    config = SamplingConfig(
        SamplingType.NODE, _norm_num_neighbors(num_neighbors),
        batch_size, shuffle, drop_last, with_edge, collect_features,
        False, False, 'out', seed)
    seeds = np.asarray(input_nodes).reshape(-1)
    # split seeds across servers; each server samples its share
    splits = np.array_split(seeds, len(self.server_ranks))
    parts = [NodeSamplerInput(p, input_type) if input_type is not None
             else p for p in splits]
    self._setup_remote(config, parts, worker_options, device)


class RemoteDistLinkNeighborLoader(_RemoteLoaderBase):
  """Remote (server-client) LINK loading: seed edges split across the
  sampling servers, whose workers draw negatives and run the (typed)
  link engine; batches stream back with edge_label metadata. Typed seed
  edges as ``((src, rel, dst), [2, E])``."""

  # link batches expose only batch-local seed indices — no global edge
  # ids to ack — so a dead server is a hard error here, not a failover
  supports_failover = False

  def __init__(self, num_neighbors, edge_label_index, edge_label=None,
               neg_sampling=None, batch_size: int = 64,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, collect_features: bool = True,
               worker_options=None, seed: Optional[int] = None,
               device=None):
    from ..sampler import NegativeSampling, SamplingConfig, SamplingType
    self._resolve_ranks(worker_options)
    edge_type, edge_label_index = _split_edge_type(edge_label_index)
    ei = np.asarray(edge_label_index)
    label = (np.asarray(edge_label).reshape(-1)
             if edge_label is not None else None)
    ns = (NegativeSampling.cast(neg_sampling)
          if neg_sampling is not None else None)
    config = SamplingConfig(
        SamplingType.LINK, _norm_num_neighbors(num_neighbors),
        batch_size, shuffle, drop_last, with_edge, collect_features,
        ns is not None, False, 'out', seed)
    nsrv = len(self.server_ranks)
    row_s = np.array_split(ei[0].reshape(-1), nsrv)
    col_s = np.array_split(ei[1].reshape(-1), nsrv)
    lab_s = (np.array_split(label, nsrv) if label is not None
             else [None] * nsrv)
    parts = [EdgeSamplerInput(r, c, label=lb, input_type=edge_type,
                              neg_sampling=ns)
             for r, c, lb in zip(row_s, col_s, lab_s)]
    self._setup_remote(config, parts, worker_options, device)
