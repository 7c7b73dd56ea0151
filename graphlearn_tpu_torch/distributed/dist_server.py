"""Sampling server: holds graph data, produces batches for remote clients.

Counterpart of ``graphlearn_tpu/distributed/dist_server.py``. The server
process owns a ``Dataset`` (on the card by default: its producers'
workers sample there), registers a producer per client request, and
streams serialized ``SampleMessage``s on demand over the TCP RPC.
``fetch_one_sampled_message`` keeps the poll contract ``(message | None,
end_of_epoch)`` with a bounded wait.

The chunk-staged block producers (``create_block_producer`` and the
other ``block_*`` RPCs) and multi-tenancy (``tenancy=``,
``update_tenant``) come with the next slice and raise
``NotImplementedError`` until then; with ``tenancy=None`` the server
behaves as JAX's does without tenancy.
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

NEXT_SLICE = ('the chunk-staged remote scan and multi-tenancy slice '
              '(ROADMAP queue A item 7)')


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
  None disables reaping. ``tenancy`` must be None: multi-tenancy comes
  with the next slice.
  """

  def __init__(self, dataset, producer_ttl: Optional[float] = None,
               tenancy=None):
    if tenancy is not None:
      raise NotImplementedError(
          f'DistServer(tenancy=...) comes with {NEXT_SLICE}')
    self.dataset = dataset
    self._producers: Dict[int, DistMpSamplingProducer] = {}
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
    self._reaper: Optional[threading.Thread] = None
    if producer_ttl is not None:
      self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
      self._reaper.start()

  def _touch(self, producer_id: int):
    self._last_active[producer_id] = time.monotonic()

  def _reap_loop(self):
    interval = min(max(self.producer_ttl / 4.0, 0.05), 30.0)
    while not self._exit.wait(interval):
      try:
        self.reap_idle_producers()
      except Exception:  # noqa: BLE001 - the reaper keeps running
        logger.exception('reaping idle producers failed')

  def reap_idle_producers(self) -> int:
    """Destroy producers idle for longer than ``producer_ttl``; returns
    the number reaped (also callable directly from tests)."""
    now = time.monotonic()
    with self._lock:
      stale = [pid for pid, ts in self._last_active.items()
               if self.producer_ttl is not None and
               now - ts > self.producer_ttl]
    for pid in stale:
      trace.counter_inc('resilience.producer_reaped')
      logger.info('reaping idle producer %d (ttl=%s)', pid,
                  self.producer_ttl)
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
    ``worker_key`` returns the producer it created."""
    if tenant is not None or priority is not None or weight is not None:
      raise NotImplementedError(f'tenant producers come with {NEXT_SLICE}')
    fault_point('server.create_producer')
    with self._lock:
      if worker_key is not None and worker_key in self._worker_key_to_id:
        pid = self._worker_key_to_id[worker_key]
        self._touch(pid)
        return pid
      pid = self._next_id
      self._next_id += 1
      buf = ShmChannel(shm_size=buffer_size)
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
          'loader to register a fresh producer')
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
    ring."""
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

  # -- the next slice's RPCs ------------------------------------------------

  def create_block_producer(self, seeds, sampling_config,
                            wire_dtype: Optional[str] = None,
                            worker_key: Optional[str] = None,
                            tenant: Optional[str] = None,
                            priority: Optional[str] = None,
                            weight: Optional[float] = None) -> int:
    raise NotImplementedError(f'block producers come with {NEXT_SLICE}')

  def block_producer_num_batches(self, producer_id: int) -> int:
    raise NotImplementedError(f'block producers come with {NEXT_SLICE}')

  def block_produce(self, producer_id: int, epoch: int, start: int,
                    k: int) -> bool:
    raise NotImplementedError(f'block producers come with {NEXT_SLICE}')

  def block_fetch(self, producer_id: int, epoch: int, start: int,
                  k: int) -> dict:
    raise NotImplementedError(f'block producers come with {NEXT_SLICE}')

  def destroy_block_producer(self, producer_id: int) -> bool:
    raise NotImplementedError(f'block producers come with {NEXT_SLICE}')

  def update_tenant(self, tenant: str, priority: Optional[str] = None,
                    weight: Optional[float] = None) -> dict:
    raise NotImplementedError(f'tenancy comes with {NEXT_SLICE}')

  # -- liveness, metrics, serving ---------------------------------------------

  def heartbeat(self) -> dict:
    """Cheap liveness probe (``resilience.Heartbeat`` polls it).
    Deliberately LOCK-FREE: ``self._lock`` is held across slow work
    (worker spawning, epoch-start ring drains), and a probe blocked
    behind it would fail over a busy but healthy server."""
    return dict(ok=True, time=time.time(),
                n_producers=len(self._producers))

  def get_metrics(self) -> dict:
    """This server PROCESS's metric snapshot (with its launch counts,
    ``ops.launch_counts()``, under 'launches') plus each live producer's
    merged worker snapshot (their launch counts too), keyed by producer
    id. Read-only, so clients may retry it."""
    from .. import ops
    srv = metrics.snapshot()
    srv['launches'] = ops.launch_counts()
    out = {'server': srv, 'producers': {}}
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
  default). ``tenancy`` must be None until the next slice."""
  global _server, _rpc_server
  if tenancy is not None:
    raise NotImplementedError(
        f'init_server(tenancy=...) comes with {NEXT_SLICE}')
  _set_server_context(num_servers, num_clients, server_rank)
  _server = DistServer(dataset, producer_ttl=producer_ttl)
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
