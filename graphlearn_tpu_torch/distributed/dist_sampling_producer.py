"""Sampling producers: collocated (in-process) and mp (worker processes)
batch production into a channel.

Counterpart of ``graphlearn_tpu/distributed/dist_sampling_producer.py``.
The mp producer spawns worker processes (``torch.multiprocessing``'s
'spawn' context) that run the sampler over a static split of the seed
range and push serialized ``SampleMessage``s into the shared channel.

A worker samples on the DATASET's device. This diverges from JAX on
purpose: JAX's workers force the CPU backend because the training
process owns the TPU, whereas a process shares the card here. A worker
rebuilds the dataset from its IPC handles (the graph's host topology,
uploaded again; each ``Feature``'s device part as a CUDA IPC handle and
its host tail in shared memory; the labels as a CUDA IPC handle), runs
the kernels there, gathers the batch's features with the row-gather
kernel, and brings the batch to the host in one device-to-host copy
(``message.to_host``). A worker on the CPU runs the plain versions. The
launch counters are per process: each worker publishes its
``ops.launch_counts()`` in the metric snapshot it sends at each epoch's
end, read through ``worker_metrics()``.

The key streams are JAX's: the worker seed ``seed * 1000003 + rank``,
the sampler's call counter (``resume_calls`` on a respawn, and a replay
from the first unsent batch), the static ``np.array_split`` of the seeds,
the epoch order from ``np.random.default_rng(seed)``, and the cyclic
``np.resize`` pad of a short link batch.
"""
import gc
import logging
import os
import queue as queue_mod
import threading
import time
from enum import Enum
from typing import Optional

import numpy as np
import torch

from .. import metrics
from ..channel import ChannelBase
from ..metrics import spans
from ..sampler import NodeSamplerInput, SamplingConfig, SamplingType
from ..utils import trace
from ..utils.faults import fault_point
from .message import hetero_output_to_message, output_to_message

logger = logging.getLogger('graphlearn_tpu_torch.producer')


class MpCommand(Enum):
  SAMPLE_ALL = 0
  STOP = 1


def _rebuild_dataset(handle):
  """The worker's ``Dataset`` from the producer's handle, on the device
  the handle names."""
  from ..data import Dataset, Feature, Graph
  device = handle['device']
  if device.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError(f'the dataset is on {device} but this sampling '
                         'worker sees no CUDA device')
    torch.cuda.set_device(device.index if device.index is not None
                          else torch.cuda.current_device())
  gipc = handle['graph_ipc']
  if isinstance(gipc, dict):
    graph = {tuple(et): Graph(h[0], h[1], device) for et, h in gipc.items()}
  else:
    graph = Graph(gipc[0], gipc[1], device)
  fipc = handle['feature_ipc']
  feature = None
  if fipc is not None:
    feature = ({t: Feature.from_ipc_handle(h) for t, h in fipc.items()}
               if isinstance(fipc, dict) else Feature.from_ipc_handle(fipc))
  return Dataset(graph, feature, None, handle['node_labels'],
                 handle['edge_dir'], device=device)


def _gather_labels(labels, node):
  """JAX's ``labels[clip(node, 0, len - 1)]`` on the labels' device."""
  idx = torch.clamp(node.to(labels.device).long(), 0, labels.shape[0] - 1)
  return labels[idx]


def _batch_message(dataset, out, collect_features: bool, hetero: bool):
  """The batch's features and labels, gathered where the dataset lives,
  and its message (one device-to-host copy)."""
  feats, labels = dataset.node_features, dataset.node_labels
  if hetero:
    x_d = y_d = None
    if collect_features and isinstance(feats, dict):
      x_d = {t: feats[t][out.node[t]] for t in out.node if t in feats}
    if isinstance(labels, dict):
      y_d = {t: _gather_labels(lab, out.node[t])
             for t, lab in labels.items() if t in out.node}
    return x_d, y_d
  x = feats[out.node] if collect_features and feats is not None else None
  y = _gather_labels(labels, out.node) if labels is not None else None
  return x, y


def _sampling_worker_loop(rank, dataset_handle, sampling_config, seeds,
                          task_queue, channel, done_counter,
                          progress=None, resume_calls: int = 0,
                          metrics_q=None):
  """Worker process body.

  Self-healing contract: after every batch lands in the channel the
  worker publishes (batches sent this epoch, sampler call_count) into
  the shared ``progress`` arrays. A crashed worker is respawned with
  ``resume_calls`` = its last published call_count and replays its
  epoch order from the first unsent batch: the sampler's fold_in
  per-call key stream makes the replayed batches bit-identical to what
  the dead worker would have produced (batch i's key depends only on
  (worker seed, call index), never on history).
  """
  try:
    _worker_body(rank, dataset_handle, sampling_config, seeds, task_queue,
                 channel, done_counter, progress, resume_calls, metrics_q)
  finally:
    # drop every CUDA IPC handle before the process ends: the Process
    # object keeps its arguments until exit, and a handle still held then
    # is never released to the producer (torch warns there that the
    # producer ended before all shared CUDA tensors were released)
    dataset_handle.clear()
    gc.collect()


def _worker_body(rank, dataset_handle, sampling_config, seeds, task_queue,
                 channel, done_counter, progress, resume_calls, metrics_q):
  from .. import ops
  from ..sampler import EdgeSamplerInput, NegativeSampling, NeighborSampler
  dataset = _rebuild_dataset(dataset_handle)
  device = dataset.device
  cuda = device.type == 'cuda'
  hetero = isinstance(dataset.graph, dict)
  input_type = dataset_handle.get('input_type')
  cfg: SamplingConfig = sampling_config
  # fold the worker rank into the seed: same-seeded workers would draw
  # IDENTICAL negative edges per batch index
  worker_seed = (0 if cfg.seed is None else cfg.seed) * 1000003 + rank
  sampler = NeighborSampler(
      dataset.graph, cfg.num_neighbors, device=device,
      with_edge=cfg.with_edge, with_weight=cfg.with_weight,
      edge_dir=cfg.edge_dir, seed=worker_seed)
  # restart path: fast-forward the key stream to where the dead worker
  # left it, so replayed batches reuse the exact per-call keys
  if resume_calls:
    sampler._call_count = resume_calls
  is_link = cfg.sampling_type == SamplingType.LINK
  if is_link:
    rows_, cols_ = seeds['rows'], seeds['cols']
    label_ = seeds.get('label')
    neg = (NegativeSampling(seeds['neg_mode'], seeds['neg_amount'])
           if seeds.get('neg_mode') else None)
    n_seeds = rows_.shape[0]
  else:
    n_seeds = seeds.shape[0]
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  parent = os.getppid()
  while True:
    try:
      cmd, payload = task_queue.get(timeout=5)
    except queue_mod.Empty:
      # orphan guard: a SIGKILL'd producer process cannot STOP its
      # workers; when the parent is gone (reparented) exit instead of
      # idling forever as a leaked process
      if os.getppid() != parent:
        return
      continue
    if cmd == MpCommand.STOP:
      break
    # payload: (epoch order, replay start batch, span wire-context): the
    # ctx joins this worker's spans to the driving client's trace (a
    # replayed command after a respawn carries the same ctx, so the
    # replacement's spans land in the same tree)
    epoch_seed_order, start_batch = payload[0], payload[1]
    span_ctx = payload[2] if len(payload) > 2 else None
    bs = cfg.batch_size
    batch_no = 0
    epoch_ctx = spans.adopt(span_ctx)
    epoch_ctx.__enter__()
    epoch_span = spans.begin('producer.epoch', worker=rank,
                             start_batch=start_batch)
    try:
      end = n_seeds - (n_seeds % bs if cfg.drop_last else 0)
      for i in range(0, end, bs):
        idx = epoch_seed_order[i:i + bs]
        if idx.shape[0] == 0:
          continue
        if batch_no < start_batch:
          # replay fast-forward: these batches landed before the previous
          # incarnation died; their keys are covered by resume_calls
          batch_no += 1
          continue
        # chaos site: an armed 'exit' here kills the worker at an exact
        # batch index with nothing in flight
        fault_point('producer.worker.batch')
        batch_span = spans.begin('producer.batch', batch=batch_no)
        try:
          t0 = time.perf_counter()
          if is_link:
            if idx.shape[0] < bs:
              # the final short batch is padded cyclically to the batch
              # shape
              idx = np.resize(idx, bs)
            out = sampler.sample_from_edges(EdgeSamplerInput(
                rows_[idx], cols_[idx],
                label=(label_[idx] if label_ is not None else None),
                input_type=input_type, neg_sampling=neg))
          else:
            out = sampler.sample_from_nodes(
                NodeSamplerInput(seeds[idx], input_type=input_type),
                batch_cap=bs)
          x, y = _batch_message(dataset, out, cfg.collect_features, hetero)
          sync()
          t1 = time.perf_counter()
          msg = (hetero_output_to_message(out, x, y) if hetero
                 else output_to_message(out, x, y))
          t2 = time.perf_counter()
          channel.send(msg)
          t3 = time.perf_counter()
          # worker-local observability: this process's own registry, sent
          # to the producer in the epoch-end snapshot below
          metrics.inc('producer.batches')
          metrics.observe('producer.sample_ms', (t3 - t0) * 1e3)
          metrics.observe('producer.sample_gather_ms', (t1 - t0) * 1e3)
          metrics.observe('producer.d2h_ms', (t2 - t1) * 1e3)
          metrics.observe('producer.send_ms', (t3 - t2) * 1e3)
          metrics.set_gauge('producer.message_bytes',
                            float(sum(a.nbytes for a in msg.values())))
        finally:
          # a raising sample/send must not strand the batch span on this
          # worker's context stack — later batches would parent under it
          spans.end(batch_span)
        batch_no += 1
        if progress is not None:
          # published AFTER the send: an uncontrolled crash between send
          # and publish replays that one batch (a duplicate) rather than
          # losing it; the chaos harness kills before the send
          sent_arr, calls_arr = progress
          with sent_arr.get_lock():
            sent_arr[rank] = batch_no
            calls_arr[rank] = sampler._call_count
    finally:
      # the epoch span and adopted context close even when a batch
      # raises out of the loop
      spans.end(epoch_span, batches=batch_no)
      epoch_ctx.__exit__(None, None, None)
    with done_counter.get_lock():
      done_counter.value += 1
    if metrics_q is not None:
      # the CUMULATIVE worker snapshot at epoch end, latest-wins per rank
      # on the other side; with it this process's launch counts
      try:
        snap = metrics.snapshot()
        snap['launches'] = ops.launch_counts()
        snap['rank'] = rank
        # this worker's span ring and the epoch's trace id: the server's
        # get_metrics exposes them, so a scrape recovers producer spans
        # by id alone
        snap['spans'] = spans.export(limit=spans.SCRAPE_EXPORT_LIMIT)
        snap['run_id'] = (span_ctx or {}).get('trace') or spans.run_id()
        metrics_q.put_nowait((rank, snap))
      except Exception:  # noqa: BLE001 - observability must not kill work
        logger.exception('worker %d could not publish its metrics', rank)


def _merge_launches(snaps) -> dict:
  out = {}
  for snap in snaps:
    for k, v in (snap.get('launches') or {}).items():
      out[k] = out.get(k, 0) + int(v)
  return out


class DistMpSamplingProducer:
  """Spawn ``num_workers`` sampling processes feeding ``channel``."""

  def __init__(self, dataset, sampler_input,
               sampling_config: SamplingConfig, channel: ChannelBase,
               num_workers: int = 1, seed: Optional[int] = None,
               max_worker_restarts: int = 2):
    self.dataset = dataset
    self.config = sampling_config
    # self-healing budget: check_worker_health respawns a crashed worker
    # (replaying its unfinished seed blocks bit-identically) at most
    # this many times per producer before giving up
    self.max_worker_restarts = max_worker_restarts
    self._restarts_used = 0
    # serializes crash detection + respawn: the server calls
    # check_worker_health from concurrent RPC handler threads, and a
    # double-respawn of one worker would replay its seed tail twice
    self._health_lock = threading.Lock()
    if hasattr(sampler_input, 'row'):     # EdgeSamplerInput (link mode)
      neg = sampler_input.neg_sampling
      self._link_input = dict(
          rows=np.asarray(sampler_input.row).reshape(-1),
          cols=np.asarray(sampler_input.col).reshape(-1),
          label=(np.asarray(sampler_input.label).reshape(-1)
                 if sampler_input.label is not None else None),
          neg_mode=(neg.mode if neg is not None else None),
          neg_amount=(neg.amount if neg is not None else 1))
      self._input_type = getattr(sampler_input, 'input_type', None)
      n = self._link_input['rows'].shape[0]
      self.seeds = None
    else:
      self._link_input = None
      self.seeds = np.asarray(sampler_input.node).reshape(-1)
      self._input_type = getattr(sampler_input, 'input_type', None)
      n = self.seeds.shape[0]
    # typed-graph contract, checked here so every mp consumer fails fast
    # instead of a worker error surfacing as a channel timeout
    if isinstance(dataset.graph, dict) and self._input_type is None:
      raise ValueError(
          'hetero sampling requires typed seeds — pass '
          "('ntype', ids) node seeds (or a NodeSamplerInput with "
          'input_type), or ((src, rel, dst), edge_label_index) link '
          'seeds (EdgeSamplerInput with input_type)')
    self._num_seeds = n
    self.channel = channel
    self.num_workers = num_workers
    self._rng = np.random.default_rng(seed)
    self._procs = []
    self._queues = []
    self._done = None
    self._splits = np.array_split(np.arange(n), num_workers)

  def _worker_seeds(self, w: int):
    if self._link_input is not None:
      sl = self._splits[w]
      li = self._link_input
      return dict(rows=li['rows'][sl], cols=li['cols'][sl],
                  label=(li['label'][sl] if li['label'] is not None
                         else None),
                  neg_mode=li['neg_mode'],
                  neg_amount=li['neg_amount'])
    return self.seeds[self._splits[w]]

  def _spawn_worker(self, w: int, resume_calls: int = 0):
    q = self._ctx.Queue()
    p = self._ctx.Process(
        target=_sampling_worker_loop,
        args=(w, self._handle, self.config, self._worker_seeds(w), q,
              self.channel, self._done, (self._sent, self._calls),
              resume_calls, self._metrics_q),
        daemon=True)
    p.start()
    self._procs[w] = p
    self._queues[w] = q

  def init(self):
    import torch.multiprocessing as tmp
    ctx = self._ctx = tmp.get_context('spawn')
    if self.dataset.device.type == 'cuda':
      # every kernel is built here, once, before the first spawn: the
      # workers load the libraries instead of each running nvcc
      from ..ops import kernels
      kernels.build_all()
    self._done = ctx.Value('i', 0)
    # per-worker progress, shared with the workers: batches sent in the
    # current epoch + the sampler's call_count — everything the restart
    # path needs to replay a dead worker exactly
    self._sent = ctx.Array('q', self.num_workers)
    self._calls = ctx.Array('q', self.num_workers)
    # worker metric snapshots ride their own small queue (epoch-end
    # cadence, latest-wins) — NEVER the data channel, whose message
    # count is the epoch-completion contract
    self._metrics_q = ctx.Queue()
    self._worker_snaps = {}
    self._metrics_drain_lock = threading.Lock()
    self._last_orders = [None] * self.num_workers
    self._last_ctx = [None] * self.num_workers
    g = self.dataset.graph
    nf = self.dataset.node_features
    self._handle = dict(
        graph_ipc=({et: gr.share_ipc() for et, gr in g.items()}
                   if isinstance(g, dict) else g.share_ipc()),
        feature_ipc=(None if nf is None else
                     {t: f.share_ipc() for t, f in nf.items()}
                     if isinstance(nf, dict) else nf.share_ipc()),
        node_labels=self.dataset.node_labels,
        edge_dir=self.dataset.edge_dir,
        input_type=getattr(self, '_input_type', None),
        device=self.dataset.device)
    self._procs = [None] * self.num_workers
    self._queues = [None] * self.num_workers
    for w in range(self.num_workers):
      self._spawn_worker(w)

  def produce_all(self):
    """Kick one epoch of sampling on all workers."""
    with self._done.get_lock():
      self._done.value = 0
    with self._sent.get_lock():
      for w in range(self.num_workers):
        self._sent[w] = 0
    if hasattr(self.channel, 'reset'):
      self.channel.reset()
    # the epoch command carries the caller's span context (the client's
    # epoch span, or an RPC handler's adopted one) so worker spans join
    # the driving trace; kept per worker for a respawn's replay
    ctx = spans.wire_context()
    for w in range(self.num_workers):
      n = self._splits[w].shape[0]
      order = (self._rng.permutation(n) if self.config.shuffle
               else np.arange(n))
      self._last_orders[w] = order
      self._last_ctx[w] = ctx
      self._queues[w].put((MpCommand.SAMPLE_ALL, (order, 0, ctx)))

  def is_all_sampling_completed(self) -> bool:
    with self._done.get_lock():
      return self._done.value == self.num_workers

  def _expected_for_worker(self, w: int) -> int:
    n = self._splits[w].shape[0]
    bs = self.config.batch_size
    return n // bs if self.config.drop_last else -(-n // bs)

  def check_worker_health(self):
    """Detect crashed sampling processes and self-heal.

    A worker with a nonzero exit code is respawned with the sampler's
    key stream fast-forwarded to its last published call_count, and its
    current epoch order is replayed from the first unsent batch —
    bit-identical to what the dead worker would have produced. After
    ``max_worker_restarts`` respawns the producer gives up and raises,
    so a deterministically-crashing worker cannot restart-loop forever.
    Thread-safe: concurrent callers serialize on a lock.
    """
    with self._health_lock:
      self._check_worker_health_locked()

  def _check_worker_health_locked(self):
    for w in range(len(self._procs)):
      p = self._procs[w]
      if p is None or p.exitcode is None or p.exitcode == 0:
        continue
      if self._restarts_used >= self.max_worker_restarts:
        raise RuntimeError(
            f'sampling worker {w} (pid={p.pid}) died with exit code '
            f'{p.exitcode} and the restart budget '
            f'({self.max_worker_restarts}) is exhausted — giving up')
      self._restarts_used += 1
      with self._sent.get_lock():
        sent = int(self._sent[w])
        calls = int(self._calls[w])
      trace.counter_inc('resilience.worker_restart')
      logger.warning(
          'sampling worker %d (pid=%s) died with exit code %s after %d '
          'batches; respawning (restart %d/%d) and replaying from batch '
          '%d', w, p.pid, p.exitcode, sent, self._restarts_used,
          self.max_worker_restarts, sent)
      self._spawn_worker(w, resume_calls=calls)
      order = self._last_orders[w]
      if order is not None and sent < self._expected_for_worker(w):
        self._queues[w].put((MpCommand.SAMPLE_ALL,
                             (order, sent, self._last_ctx[w])))

  def worker_metrics(self):
    """Merged metric snapshot across this producer's workers, or None
    before any worker has published (workers push cumulative snapshots
    at epoch end; latest-wins per rank). ``launches`` is the sum of the
    workers' launch counts, ``workers`` the ranks that published,
    ``spans`` their span rings, concatenated."""
    q = getattr(self, '_metrics_q', None)
    if q is None:
      return None
    with self._metrics_drain_lock:
      while True:
        try:
          rank, snap = q.get_nowait()
        except (queue_mod.Empty, OSError, ValueError):
          break
        self._worker_snaps[rank] = snap
      if not self._worker_snaps:
        return None
      snaps = list(self._worker_snaps.values())
      ranks = sorted(self._worker_snaps)
    merged = metrics.merge_snapshots(snaps)
    merged['launches'] = _merge_launches(snaps)
    merged['workers'] = ranks
    # span rings don't merge — concatenate them (and carry a run_id) so
    # get_metrics / scrape_all expose producer spans per role
    span_rows = [r for snap in snaps for r in snap.get('spans', ())]
    if span_rows:
      merged['spans'] = span_rows
    for snap in snaps:
      if snap.get('run_id'):
        merged['run_id'] = snap['run_id']
        break
    return merged

  def num_expected(self) -> int:
    bs = self.config.batch_size
    total = 0
    for s in self._splits:
      n = s.shape[0]
      total += n // bs if self.config.drop_last else -(-n // bs)
    return total

  def shutdown(self):
    """Stop and join every worker, then release the dataset's handles.
    Idempotent: a second shutdown is a no-op."""
    if getattr(self, '_shutdown_done', False):
      return
    self._shutdown_done = True
    for q in self._queues:
      if q is not None:
        q.put((MpCommand.STOP, None))
    deadline = time.monotonic() + 10
    for p in self._procs:
      if p is None:
        continue
      while p.is_alive() and time.monotonic() < deadline:
        self.worker_metrics()   # drain the snapshot queue before joining
        p.join(timeout=0.1)
      if p.is_alive():
        logger.warning('sampling worker %s did not exit within 10s; '
                       'terminating', p.pid)
        p.terminate()
        p.join(timeout=5)
    self.worker_metrics()
    # the workers are gone: only now may the CUDA IPC handles go
    self._handle = None


class DistCollocatedSamplingProducer:
  """In-process synchronous producer on the dataset's device."""

  def __init__(self, dataset, sampler_input: NodeSamplerInput,
               sampling_config: SamplingConfig,
               seed: Optional[int] = None):
    from ..sampler import NeighborSampler
    self.dataset = dataset
    self.seeds = np.asarray(sampler_input.node).reshape(-1)
    self.config = sampling_config
    cfg = sampling_config
    self.sampler = NeighborSampler(
        dataset.graph, cfg.num_neighbors, device=dataset.device,
        with_edge=cfg.with_edge, with_weight=cfg.with_weight,
        edge_dir=cfg.edge_dir, seed=cfg.seed)
    self._rng = np.random.default_rng(seed)
    self._order = None
    self._pos = 0

  def reset(self):
    self._order = (self._rng.permutation(self.seeds.shape[0])
                   if self.config.shuffle
                   else np.arange(self.seeds.shape[0]))
    self._pos = 0

  def sample(self):
    """Produce the next batch's message, or None at epoch end."""
    if self._order is None:
      self.reset()
    bs = self.config.batch_size
    n = self.seeds.shape[0]
    if self._pos >= n or (self.config.drop_last and
                          self._pos + bs > n):
      return None
    idx = self._order[self._pos:self._pos + bs]
    self._pos += bs
    out = self.sampler.sample_from_nodes(NodeSamplerInput(self.seeds[idx]),
                                         batch_cap=bs)
    x, y = _batch_message(self.dataset, out, self.config.collect_features,
                          False)
    return output_to_message(out, x, y)
