"""Sampling server: holds graph data, produces batches for remote clients.

Counterpart of ``graphlearn_tpu/distributed/dist_server.py``. The server
process owns a ``Dataset`` (on the card by default: its producers'
workers sample there), registers a producer per client request, and
streams serialized ``SampleMessage``s on demand over the TCP RPC.
``fetch_one_sampled_message`` keeps the poll contract ``(message | None,
end_of_epoch)`` with a bounded wait.

The chunk-staged remote scan's block streams (``create_block_producer``
and the other ``block_*`` RPCs, ``distributed/block_producer.py``) are
counter-addressed replays on the server's dataset device: no worker
process, no ring, so their lifecycle is a dict. ``tenancy=``
(``tenancy.TenancyConfig``) turns on the multi-tenant plane: admission
quotas at producer creation and in the block handlers (typed, retryable
rejections), the weighted-fair block lane, per-tenant ``producer_ttl``
and the tenants' quota state in ``get_metrics``; with ``tenancy=None``
the server behaves as JAX's does without tenancy.
"""
import dataclasses
import logging
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .. import metrics
from ..channel import QueueTimeoutError, ShmChannel
from ..sampler import (EdgeSamplerInput, NegativeSampling, NodeSamplerInput,
                       RemoteSamplerInput, SamplingConfig, SamplingType)
from ..utils import trace
from ..utils.faults import fault_point
from .dist_context import _set_server_context
from .dist_sampling_producer import DistMpSamplingProducer
from .rpc import Barrier, RpcServer

logger = logging.getLogger('graphlearn_tpu_torch.server')


def _node_input(seeds) -> NodeSamplerInput:
  """A producer's node seeds: a ``NodeSamplerInput`` (typed seeds ride
  one), a server-side ``RemoteSamplerInput`` (loaded here) or bare
  ids."""
  if isinstance(seeds, NodeSamplerInput):
    return seeds
  if isinstance(seeds, RemoteSamplerInput):
    return seeds.to_input()
  return NodeSamplerInput(np.asarray(seeds))


class DistServer:
  """Owns ``dataset`` and the producers remote clients create.

  ``producer_ttl``: seconds of producer inactivity (no fetch / epoch
  start) after which a background reaper destroys the producer and
  releases its ``ShmChannel`` — the backstop against clients that
  disconnect mid-stream without calling ``destroy_sampling_producer``.
  None disables reaping.

  ``tenancy`` (``tenancy.TenancyConfig``) turns on the multi-tenant
  plane: per-tenant admission quotas at producer creation and in the
  block handlers, the weighted-fair block lane, per-tenant
  ``producer_ttl`` overrides (one vanished client reaps only its own
  streams) and per-tenant quota state in ``get_metrics``. None keeps the
  single-tenant behaviour.
  """

  def __init__(self, dataset, producer_ttl: Optional[float] = None,
               tenancy=None):
    from .tenancy import AdmissionController, WeightedFairScheduler
    self.dataset = dataset
    self._producers: Dict[int, DistMpSamplingProducer] = {}
    # chunk-staged block streams: counter-addressed replays, no worker
    # process and no ring, so their lifecycle is this dict
    self._block_producers: Dict[int, object] = {}
    self._block_key_to_id: Dict[str, int] = {}
    self._buffers: Dict[int, ShmChannel] = {}
    # per-producer fetch locks: destroy (client call OR idle reaper)
    # must not close a ring while a fetch thread is blocked inside its
    # native recv — that is a use-after-free on the ring
    self._fetch_locks: Dict[int, threading.Lock] = {}
    self._expected: Dict[int, int] = {}
    self._received: Dict[int, int] = {}
    self._last_active: Dict[int, float] = {}
    self._next_id = 0
    self._worker_key_to_id: Dict[str, int] = {}
    self._lock = threading.RLock()
    self._exit = threading.Event()
    self.producer_ttl = producer_ttl
    self._serving = None
    self._admission = (AdmissionController(tenancy)
                       if tenancy is not None else None)
    self._scheduler = (WeightedFairScheduler(
        self._admission, quantum=tenancy.quantum,
        timeout=tenancy.sched_timeout) if tenancy is not None else None)
    self._reaper: Optional[threading.Thread] = None
    if self._min_ttl() is not None:
      self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
      self._reaper.start()

  def _min_ttl(self) -> Optional[float]:
    """The smallest armed reap threshold (server-wide or any tenant's):
    the reaper runs when any is armed and polls at its cadence."""
    if self._admission is not None:
      return self._admission.min_ttl(self.producer_ttl)
    return self.producer_ttl

  def _pid_ttl(self, pid: int) -> Optional[float]:
    if self._admission is not None:
      return self._admission.ttl_for_pid(pid, self.producer_ttl)
    return self.producer_ttl

  def _pid_context(self, pid: int) -> str:
    """Tenant and quota context of a stale-handle error ('' without
    tenancy)."""
    if self._admission is None:
      return ''
    return self._admission.describe_pid(pid)

  def _touch(self, producer_id: int):
    self._last_active[producer_id] = time.monotonic()

  def _reap_loop(self):
    interval = min(max((self._min_ttl() or 1.0) / 4.0, 0.05), 30.0)
    while not self._exit.wait(interval):
      try:
        self.reap_idle_producers()
      except Exception:  # noqa: BLE001 - the reaper keeps running
        logger.exception('reaping idle producers failed')

  def reap_idle_producers(self) -> int:
    """Destroy producers idle for longer than their reap threshold (the
    tenant's ``producer_ttl`` with tenancy on, else the server-wide one);
    returns the number reaped (also callable directly from tests). Each
    reap counts under ``tenant.reaped.<tenant>``."""
    now = time.monotonic()
    with self._lock:
      stale = []
      for pid, ts in self._last_active.items():
        ttl = self._pid_ttl(pid)
        if ttl is not None and now - ts > ttl:
          stale.append(pid)
      stale_blocks = {pid for pid in stale if pid in self._block_producers}
    for pid in stale:
      fault_point('tenant.reap')
      tenant = (self._admission.tenant_of(pid)
                if self._admission is not None else 'default')
      trace.counter_inc('resilience.producer_reaped')
      metrics.inc(f'tenant.reaped.{tenant}')
      logger.info('reaping idle producer %d of tenant %r (ttl=%s)', pid,
                  tenant, self._pid_ttl(pid))
      if self._admission is not None:
        self._admission.release_producer(pid, reaped=True)
      if pid in stale_blocks:
        self.destroy_block_producer(pid)
      else:
        self.destroy_sampling_producer(pid)
    return len(stale)

  # -- producer lifecycle ---------------------------------------------------

  def create_sampling_producer(self, seeds, sampling_config: SamplingConfig,
                               num_workers: int = 1,
                               buffer_size: int = 1 << 26,
                               worker_key: Optional[str] = None,
                               tenant: Optional[str] = None,
                               priority: Optional[str] = None,
                               weight: Optional[float] = None) -> int:
    """A producer over ``seeds`` with ``num_workers`` sampling workers
    and a ring of ``buffer_size`` bytes; its id. A repeated
    ``worker_key`` returns the producer it created. With tenancy on,
    ``tenant`` / ``priority`` / ``weight`` register it with the admission
    controller, which admits it with its ring bytes before anything is
    allocated (an over-quota tenant gets a retryable
    ``TenantQuotaExceeded``)."""
    fault_point('server.create_producer')
    with self._lock:
      if worker_key is not None and worker_key in self._worker_key_to_id:
        pid = self._worker_key_to_id[worker_key]
        self._touch(pid)
        return pid
      pid = self._next_id
      self._next_id += 1
      if self._admission is not None:
        self._admission.admit_producer(
            tenant or 'default', pid, ring_bytes=int(buffer_size),
            priority=priority, weight=weight)
      try:
        buf = ShmChannel(shm_size=buffer_size)
      except BaseException:
        if self._admission is not None:
          self._admission.release_producer(pid)
        raise
      try:
        # the server's dataset is the authority on edge orientation —
        # remote clients can't know it and default to 'out'
        sampling_config = dataclasses.replace(
            sampling_config, edge_dir=self.dataset.edge_dir)
        if sampling_config.sampling_type == SamplingType.LINK:
          # seeds arrive as [2, E] (or an EdgeSamplerInput); negatives
          # are requested through config.with_neg (binary, amount 1 —
          # pass an EdgeSamplerInput for other modes)
          if not isinstance(seeds, EdgeSamplerInput):
            ei = np.asarray(seeds)
            seeds = EdgeSamplerInput(
                ei[0], ei[1],
                neg_sampling=(NegativeSampling('binary', 1)
                              if sampling_config.with_neg else None))
          sampler_input = seeds
        else:
          sampler_input = _node_input(seeds)
        producer = DistMpSamplingProducer(
            self.dataset, sampler_input, sampling_config, buf,
            num_workers=num_workers)
        producer.init()
      except BaseException:
        buf.close()
        # a failed create does not hold the tenant's admission slot
        if self._admission is not None:
          self._admission.release_producer(pid)
        raise
      self._producers[pid] = producer
      self._buffers[pid] = buf
      self._fetch_locks[pid] = threading.Lock()
      self._expected[pid] = producer.num_expected()
      self._received[pid] = 0
      self._touch(pid)
      if worker_key is not None:
        self._worker_key_to_id[worker_key] = pid
      return pid

  def _live_producer(self, producer_id: int):
    """Producer and ring for an id, or a diagnosable error (after an idle
    reap or a double destroy)."""
    producer = self._producers.get(producer_id)
    buf = self._buffers.get(producer_id)
    if producer is None or buf is None:
      raise RuntimeError(
          f'producer {producer_id} unknown on this server — it was '
          'destroyed or idle-reaped (producer_ttl); recreate the remote '
          'loader to register a fresh producer'
          f'{self._pid_context(producer_id)}')
    return producer, buf

  def producer_num_expected(self, producer_id: int) -> int:
    """Exact number of batches this producer emits per epoch (its
    workers each round their seed share up)."""
    with self._lock:
      self._live_producer(producer_id)
      return self._expected[producer_id]

  def start_new_epoch_sampling(self, producer_id: int):
    with self._lock:
      producer, buf = self._live_producer(producer_id)
      self._touch(producer_id)
      # Drain messages left over from an abandoned previous epoch so they
      # are not served as (and counted against) the new epoch's batches.
      # A still-producing abandoned epoch keeps writing until its seeds
      # are exhausted; wait it out first (bounded by production time).
      if 0 < self._received.get(producer_id, 0) < \
          self._expected.get(producer_id, 0):
        deadline = time.time() + 120.0
        while not producer.is_all_sampling_completed():
          if time.time() > deadline:
            break
          time.sleep(0.05)
      while not buf.empty():
        try:
          buf.recv(timeout_ms=10)
        except (QueueTimeoutError, StopIteration):
          break
      self._received[producer_id] = 0
    producer.produce_all()

  def fetch_one_sampled_message(self, producer_id: int,
                                timeout_ms: int = 500
                                ) -> Tuple[Optional[dict], bool]:
    """``(message | None, end_of_epoch)`` after at most ``timeout_ms``."""
    fault_point('server.fetch')
    t0 = time.perf_counter()
    # one atomic preamble: existence check, touch, count check and the
    # fetch-lock lookup see one consistent producer state
    with self._lock:
      producer, buf = self._live_producer(producer_id)
      fetch_lock = self._fetch_locks[producer_id]
      self._touch(producer_id)
      if self._received[producer_id] >= self._expected[producer_id]:
        return None, True
    try:
      with fetch_lock:
        if producer_id not in self._buffers:   # destroyed while waiting
          return None, True
        msg = buf.recv(timeout_ms=timeout_ms)
    except QueueTimeoutError:
      # nothing buffered: the epoch is done, or a worker crashed
      # mid-epoch — self-heal (restart + replay, bounded by the
      # producer's restart budget) so the client's stream resumes
      producer.check_worker_health()
      done = (producer.is_all_sampling_completed() and buf.empty())
      return None, done
    except StopIteration:
      return None, True
    with self._lock:
      self._received[producer_id] += 1
      end = self._received[producer_id] >= self._expected[producer_id]
    metrics.observe('server.fetch_ms', (time.perf_counter() - t0) * 1e3)
    return msg, end

  def destroy_sampling_producer(self, producer_id: int):
    """Idempotent: destroying an unknown or already-destroyed producer is
    a no-op. Stops and joins the producer's workers, then releases its
    ring (and, with tenancy on, the tenant's admission slot)."""
    if self._admission is not None:
      self._admission.release_producer(producer_id)
    with self._lock:
      producer = self._producers.pop(producer_id, None)
      buf = self._buffers.pop(producer_id, None)
      self._expected.pop(producer_id, None)
      self._received.pop(producer_id, None)
      self._last_active.pop(producer_id, None)
      fetch_lock = self._fetch_locks.pop(producer_id, None)
      for k, v in list(self._worker_key_to_id.items()):
        if v == producer_id:
          del self._worker_key_to_id[k]
    if producer:
      producer.shutdown()
    if buf:
      if fetch_lock is not None:
        # wait out any fetch blocked in the ring's native recv (bounded
        # by the fetch poll timeout) before freeing the shared memory
        with fetch_lock:
          buf.close()
      else:
        buf.close()
    return True

  # -- chunk-staged block streams (distributed/block_producer.py). A block
  # is a pure function of (share, config, epoch, batch range), so every
  # handler here is idempotent and the client calls them with retry.

  def create_block_producer(self, seeds, sampling_config,
                            wire_dtype: Optional[str] = None,
                            worker_key: Optional[str] = None,
                            tenant: Optional[str] = None,
                            priority: Optional[str] = None,
                            weight: Optional[float] = None) -> int:
    """Register a block stream over a seed share; its id. ``worker_key``
    dedups re-creates (client retries, failover replay producers on
    survivors) as the sampling producers' key does. ``tenant`` /
    ``priority`` / ``weight`` register the stream with the admission
    controller: its staged frame bytes then count against the tenant's
    in-flight quota and its builds drain through the weighted-fair
    lane."""
    from .block_producer import BlockSampleProducer
    with self._lock:
      if worker_key is not None and worker_key in self._block_key_to_id:
        pid = self._block_key_to_id[worker_key]
        self._touch(pid)
        return pid
      pid = self._next_id
      self._next_id += 1
      if self._admission is not None:
        self._admission.admit_producer(
            tenant or 'default', pid, ring_bytes=0,
            priority=priority, weight=weight)
      # the server's dataset is the authority on edge orientation
      cfg = dataclasses.replace(sampling_config,
                                edge_dir=self.dataset.edge_dir)
      try:
        producer = BlockSampleProducer(self.dataset, seeds, cfg,
                                       wire_dtype=wire_dtype)
      except BaseException:
        if self._admission is not None:
          self._admission.release_producer(pid)
        raise
      if self._admission is not None:
        # in-flight bytes: charged as a frame stages into the producer's
        # cache, released as the client fetches it
        adm, t = self._admission, (tenant or 'default')
        producer.on_stage = lambda n: adm.charge_inflight(t, n)
        producer.on_fetch = lambda n: adm.release_inflight(t, n)
      self._block_producers[pid] = producer
      self._touch(pid)
      if worker_key is not None:
        self._block_key_to_id[worker_key] = pid
      return pid

  def _live_block_producer(self, producer_id: int):
    producer = self._block_producers.get(producer_id)
    if producer is None:
      raise RuntimeError(
          f'block producer {producer_id} unknown on this server — it '
          'was destroyed or idle-reaped (producer_ttl); recreate the '
          'remote scan trainer to register a fresh stream'
          f'{self._pid_context(producer_id)}')
    return producer

  def _block_lane(self, producer_id: int, k: int, fn):
    """Run a block build or fetch through the weighted-fair lane (strict
    priority, then deficit-weighted round robin); a direct call without
    tenancy. The cost is the batch count: a tail block is cheaper."""
    if self._scheduler is None:
      return fn()
    tenant = self._admission.tenant_of(producer_id)
    return self._scheduler.run(tenant, float(k), fn)

  def block_producer_num_batches(self, producer_id: int) -> int:
    """Batches per epoch of this block stream."""
    with self._lock:
      producer = self._live_block_producer(producer_id)
      self._touch(producer_id)
    return producer.num_batches()

  def block_produce(self, producer_id: int, epoch: int, start: int,
                    k: int) -> bool:
    """Stage block (epoch, [start, start + k)) into the frame cache: the
    produce half of the client's produce-c+1-while-fetching-c. With
    tenancy on, a tenant at its in-flight byte quota gets a retryable
    ``TenantThrottled`` (producing ahead is optional work; fetching the
    staged frames drains the quota), and the build drains through the
    weighted-fair lane."""
    with self._lock:
      producer = self._live_block_producer(producer_id)
      self._touch(producer_id)
    if self._admission is not None:
      self._admission.check_inflight(self._admission.tenant_of(producer_id))
    return self._block_lane(
        producer_id, k, lambda: producer.produce(epoch, start, k))

  def block_fetch(self, producer_id: int, epoch: int, start: int,
                  k: int) -> dict:
    """The block frame (cache pop, or built on demand): pure, so a
    retried fetch rebuilds identical bytes. It goes through the
    weighted-fair lane and is never throttled by the in-flight quota:
    fetching drains it."""
    with self._lock:
      producer = self._live_block_producer(producer_id)
      self._touch(producer_id)
    return self._block_lane(
        producer_id, k, lambda: producer.fetch(epoch, start, k))

  def block_build_log(self, producer_id: int) -> list:
    """The block stream's ``build_log`` (per built frame: its range,
    bytes, the sampling and gather, pack and host-copy ms). Read-only."""
    with self._lock:
      producer = self._live_block_producer(producer_id)
    return list(producer.build_log)

  def destroy_block_producer(self, producer_id: int) -> bool:
    """Idempotent, as ``destroy_sampling_producer``. Releases any
    still-staged frame bytes and the tenant's admission slot."""
    with self._lock:
      producer = self._block_producers.pop(producer_id, None)
      self._last_active.pop(producer_id, None)
      for key, pid in list(self._block_key_to_id.items()):
        if pid == producer_id:
          del self._block_key_to_id[key]
    if self._admission is not None:
      tenant = self._admission.tenant_of(producer_id)
      leftover = producer.cached_bytes() if producer is not None else 0
      if leftover:
        self._admission.release_inflight(tenant, leftover)
      self._admission.release_producer(producer_id)
    return True

  def update_tenant(self, tenant: str, priority: Optional[str] = None,
                    weight: Optional[float] = None) -> dict:
    """Re-register a tenant's priority or weight mid-flight and return
    its quota snapshot. Idempotent."""
    if self._admission is None:
      raise RuntimeError('tenancy is not enabled on this server '
                         '(DistServer(tenancy=TenancyConfig(...)))')
    self._admission.register(tenant, priority=priority, weight=weight)
    return self._admission.snapshot(tenant)

  # -- liveness, metrics, serving ---------------------------------------------

  def heartbeat(self) -> dict:
    """Cheap liveness probe (``resilience.Heartbeat`` polls it).
    Deliberately LOCK-FREE: ``self._lock`` is held across slow work
    (worker spawning, epoch-start ring drains), and a probe blocked
    behind it would fail over a busy but healthy server."""
    return dict(ok=True, time=time.time(),
                n_producers=len(self._producers))

  def get_metrics(self) -> dict:
    """Scrape endpoint (``metrics.scrape_all``): this server PROCESS's
    metric snapshot (with its launch counts, ``ops.launch_counts()``,
    under 'launches', its run_id and its span ring) plus each live
    producer's merged worker snapshot (their launch counts and spans
    too), keyed by producer id. Read-only, so clients may retry it."""
    from .. import ops
    from ..metrics import spans
    srv = metrics.snapshot()
    srv['launches'] = ops.launch_counts()
    # run_id + the span ring ride the snapshot (extra keys, ignored by
    # merge_snapshots): the scraping client recovers this server's spans
    # — and the producers' worker spans below — by id alone
    srv['run_id'] = spans.run_id()
    srv['spans'] = spans.export(limit=spans.SCRAPE_EXPORT_LIMIT)
    out = {'server': srv, 'producers': {}}
    if self._admission is not None:
      # per-tenant quota and usage state: visible backpressure
      out['tenants'] = self._admission.snapshot_all()
      out['tenant_served'] = dict(self._scheduler.served)
    with self._lock:
      producers = dict(self._producers)
    for pid, producer in producers.items():
      workers = producer.worker_metrics()
      if workers:
        out['producers'][pid] = workers
    return out

  def register_serving_engine(self, engine):
    """Attach an online embedding endpoint (``serving.ServingEngine``)
    so remote clients can look embeddings up through the ``serve``
    RPC."""
    self._serving = engine

  def serve(self, ids):
    """Embedding lookup RPC: ids -> ``[n, F]`` numpy rows, through the
    engine's admission queue (remote traffic batches with local traffic
    into the same buckets). Read-only, so clients may retry it."""
    engine = self._serving
    if engine is None:
      raise RuntimeError('no serving engine registered on this server '
                         '(DistServer.register_serving_engine)')
    return engine.serve_numpy(np.asarray(ids, np.int64))

  def get_dataset_meta(self):
    g = self.dataset.graph
    if isinstance(g, dict):     # typed: per-etype counts
      return dict(
          num_nodes={et: gr.num_nodes for et, gr in g.items()},
          num_edges={et: gr.num_edges for et, gr in g.items()},
          edge_types=sorted(tuple(et) for et in g),
          edge_dir=self.dataset.edge_dir)
    return dict(num_nodes=g.num_nodes, num_edges=g.num_edges,
                edge_dir=self.dataset.edge_dir)

  def exit(self):
    """Idempotent shutdown: destroys every producer (joining its workers
    and releasing its ring) and signals ``wait_for_exit``."""
    for pid in list(self._producers):
      self.destroy_sampling_producer(pid)
    for pid in list(self._block_producers):
      self.destroy_block_producer(pid)
    if self._scheduler is not None:
      self._scheduler.close()
    self._exit.set()
    return True

  def wait_for_exit(self, timeout: Optional[float] = None) -> bool:
    return self._exit.wait(timeout)


_server: Optional[DistServer] = None
_rpc_server: Optional[RpcServer] = None


def get_server() -> Optional[DistServer]:
  return _server


def init_server(num_servers: int, num_clients: int, server_rank: int,
                dataset, master_addr: str = '127.0.0.1',
                server_client_master_port: int = 0,
                producer_ttl: Optional[float] = None,
                tenancy=None) -> Tuple[str, int]:
  """Start this server's RPC endpoint; returns ``(host, port)`` to hand
  to the clients (port 0 binds a free one). ``producer_ttl`` bounds how
  long a producer abandoned by a vanished client holds its ring (off by
  default). ``tenancy`` (``tenancy.TenancyConfig``) arms the
  multi-tenant plane: admission quotas, weighted-fair block scheduling
  and per-tenant ttls."""
  global _server, _rpc_server
  _set_server_context(num_servers, num_clients, server_rank)
  _server = DistServer(dataset, producer_ttl=producer_ttl,
                       tenancy=tenancy)
  s = _server
  barrier = Barrier(num_clients)
  # handlers registered at construction: the server accepts connections
  # the moment it binds, and a fast client must not see a half-registered
  # callee table
  _rpc_server = RpcServer(
      master_addr, server_client_master_port,
      handlers={
          'create_sampling_producer': s.create_sampling_producer,
          'producer_num_expected': s.producer_num_expected,
          'start_new_epoch_sampling': s.start_new_epoch_sampling,
          'fetch_one_sampled_message': s.fetch_one_sampled_message,
          'destroy_sampling_producer': s.destroy_sampling_producer,
          'create_block_producer': s.create_block_producer,
          'block_producer_num_batches': s.block_producer_num_batches,
          'block_produce': s.block_produce,
          'block_fetch': s.block_fetch,
          'destroy_block_producer': s.destroy_block_producer,
          'block_build_log': s.block_build_log,
          'update_tenant': s.update_tenant,
          'get_dataset_meta': s.get_dataset_meta,
          'heartbeat': s.heartbeat,
          'get_metrics': s.get_metrics,
          'serve': s.serve,
          'exit': s.exit,
          'client_barrier': barrier.arrive,
      })
  return _rpc_server.host, _rpc_server.port


def wait_and_shutdown_server(timeout: Optional[float] = None):
  """Block until a client calls ``exit`` (or ``timeout``), then close the
  endpoint; every producer is destroyed either way."""
  global _server, _rpc_server
  if _server is not None:
    _server.wait_for_exit(timeout)
    _server.exit()
    time.sleep(0.1)  # let the exit RPC response flush
  if _rpc_server is not None:
    _rpc_server.shutdown()
  _server = None
  _rpc_server = None
