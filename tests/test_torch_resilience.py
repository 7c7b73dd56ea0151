"""The port's resilience layer, on the CPU.

Mirrors ``tests/test_resilience.py``: ``RetryPolicy`` backoff and
budgets, the fault-injection registry, ``Heartbeat`` liveness, the RPC's
idempotent retry, contextual channel timeouts, and the server's
shutdown and ring-release invariants; then the self-healing producer of
``tests/test_chaos.py``: a sampling worker killed mid-epoch is respawned
and replays its unsent batches bit-identically to an undisturbed epoch.
The port's counters and fault sites are its own (``utils.trace``,
``utils.faults``), named as JAX's.
"""
import threading
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.channel import live_channel_count
from graphlearn_tpu_torch.utils import faults, trace

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

gdist = gtt.distributed


@pytest.fixture(autouse=True)
def _clean_faults():
  faults.disarm()
  trace.reset_counters()
  base = live_channel_count()
  yield
  faults.disarm()
  trace.reset_counters()
  assert live_channel_count() == base


# ---------------------------------------------------------------- RetryPolicy


def test_retry_policy_backoff_schedule_deterministic():
  p = gdist.RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=0.3,
                        multiplier=2.0, jitter=0.5, seed=7)
  d1, d2 = list(p.delays()), list(p.delays())
  assert d1 == d2 and len(d1) == 3
  for d, cap in zip(d1, [0.1, 0.2, 0.3]):
    assert cap * 0.5 <= d <= cap


def test_retry_policy_retries_then_succeeds():
  calls = []

  def flaky():
    calls.append(1)
    if len(calls) < 3:
      raise ConnectionError('transient')
    return 'ok'

  p = gdist.RetryPolicy(max_attempts=4, base_delay=0.01, total_deadline=10)
  assert p.run(flaky) == 'ok'
  assert len(calls) == 3
  assert trace.counter_get('resilience.retry') == 2


def test_retry_policy_exhausts_attempts():
  p = gdist.RetryPolicy(max_attempts=3, base_delay=0.005, total_deadline=10)
  calls = []

  def always_fail():
    calls.append(1)
    raise TimeoutError('nope')

  with pytest.raises(gdist.DeadlineExceeded, match='after 3 attempt'):
    p.run(always_fail)
  assert len(calls) == 3


def test_retry_policy_total_deadline_stops_early():
  p = gdist.RetryPolicy(max_attempts=100, base_delay=0.2, multiplier=1.0,
                        jitter=0.0, total_deadline=0.5)
  t0 = time.monotonic()
  with pytest.raises(gdist.DeadlineExceeded):
    p.run(lambda: (_ for _ in ()).throw(ConnectionError('x')))
  assert time.monotonic() - t0 < 2.0


def test_retry_policy_non_retryable_error_propagates():
  calls = []

  def boom():
    calls.append(1)
    raise ValueError('logic bug')

  with pytest.raises(ValueError):
    gdist.RetryPolicy(max_attempts=5, base_delay=0.01).run(boom)
  assert len(calls) == 1


# ---------------------------------------------------------------- faults


def test_fault_point_disarmed_is_noop_no_dispatch(monkeypatch):
  monkeypatch.setattr(faults, '_fire',
                      lambda name: (_ for _ in ()).throw(
                          AssertionError('dispatched while disarmed')))
  assert not faults.armed()
  for _ in range(1000):
    assert faults.fault_point('anything') is None
  assert trace.counters('fault.') == {}


def test_fault_point_raise_delay_drop_and_counters():
  with faults.injected('site.a', 'raise', times=2):
    for _ in range(2):
      with pytest.raises(faults.FaultError):
        faults.fault_point('site.a')
    assert faults.fault_point('site.a') is None   # times exhausted
  assert trace.counter_get('fault.site.a') == 2
  with faults.injected('site.b', 'drop', after=1):
    assert faults.fault_point('site.b') is None   # skipped (after=1)
    assert faults.fault_point('site.b') == 'drop'
  with faults.injected('site.c', 'delay', delay=0.05, times=1):
    t0 = time.monotonic()
    faults.fault_point('site.c')
    assert time.monotonic() - t0 >= 0.05
  with faults.injected('site.d', 'raise', exc=ConnectionError):
    with pytest.raises(ConnectionError):
      faults.fault_point('site.d')
  assert faults.stats('site.d') == (0, 0)


def test_fault_env_spec_roundtrip():
  faults._parse_env('x.y:exit:after=3,times=1,code=17;p.q:raise')
  try:
    f = faults.armed()['x.y']
    assert (f.kind, f.after, f.times, f.code) == ('exit', 3, 1, 17)
    assert faults.armed()['p.q'].kind == 'raise'
  finally:
    faults.disarm()
  with pytest.raises(ValueError):
    faults._parse_env('bad:raise:exc=NotAnException')
  assert not faults.load_env('bad:raise:exc=NotAnException')
  assert faults.env_spec('a:raise', 'b:drop') == {'GLT_FAULTS':
                                                  'a:raise;b:drop'}


def test_registered_sites_are_jax_s_and_the_seams_pass_them():
  """The port names JAX's sites; the recovery and staging seams fire
  theirs (``recovery.roll_back``, ``storage.dist_stage``,
  ``storage.stage``)."""
  from graphlearn_tpu.utils import faults as jfaults
  from graphlearn_tpu_torch.recovery import FailoverRunner
  from graphlearn_tpu_torch.storage.dist_scan import DistChunkStager
  from graphlearn_tpu_torch.storage.staging import ChunkStager
  assert faults.REGISTERED_SITES == jfaults.REGISTERED_SITES
  for site, fire in (
      ('recovery.roll_back',
       lambda: FailoverRunner._roll_back_fault(None)),
      ('storage.dist_stage',
       lambda: DistChunkStager._stage_fault(None)),
      ('storage.stage', lambda: ChunkStager._stage_fault(None))):
    assert site in faults.REGISTERED_SITES
    fire()    # disarmed: nothing happens
    with faults.injected(site, 'raise', times=1):
      with pytest.raises(faults.FaultError, match=site):
        fire()
    assert trace.counter_get(f'fault.{site}') == 1


# ---------------------------------------------------------------- Heartbeat


def test_heartbeat_declares_dead_after_misses():
  healthy = threading.Event()
  healthy.set()
  deaths = []

  def probe(rank):
    if not healthy.is_set():
      raise ConnectionError('down')

  hb = gdist.Heartbeat([0], probe, interval=0.05, miss_threshold=3,
                       on_dead=lambda r, c: deaths.append(r))
  hb.start()
  try:
    time.sleep(0.3)
    assert not hb.dead_ranks()
    healthy.clear()
    deadline = time.monotonic() + 10
    while not deaths and time.monotonic() < deadline:
      time.sleep(0.02)
    assert hb.is_dead(0) and deaths == [0]
    assert trace.counter_get('resilience.server_dead') == 1
  finally:
    hb.stop()


def test_heartbeat_probe_fault_site():
  faults.arm('heartbeat.probe', 'raise', exc=ConnectionError)
  hb = gdist.Heartbeat([3], lambda rank: None, interval=0.05,
                       miss_threshold=2)
  hb.start()
  try:
    deadline = time.monotonic() + 5
    while not hb.is_dead(3) and time.monotonic() < deadline:
      time.sleep(0.02)
    assert hb.is_dead(3)
    assert trace.counter_get('fault.heartbeat.probe') >= 2
  finally:
    hb.stop()


def test_heartbeat_mark_dead_external():
  hb = gdist.Heartbeat([0, 1], lambda r: None, interval=10)
  hb.mark_dead(1, 'hard rpc failure')
  assert hb.dead_ranks() == {1: 'hard rpc failure'}
  hb.mark_dead(1, 'again')   # idempotent, counted once
  assert trace.counter_get('resilience.server_dead') == 1


# ---------------------------------------------------------------- rpc retry


@pytest.fixture
def rpc_pair():
  server = gdist.RpcServer()
  client = gdist.RpcClient()
  client.add_target(0, server.host, server.port)
  yield server, client
  client.close()
  server.shutdown()


def test_rpc_idempotent_retry_with_injected_fault(rpc_pair):
  server, client = rpc_pair
  server.register('get', lambda: 42)
  faults.arm('rpc.client.request', 'raise', exc=ConnectionError, times=1)
  policy = gdist.RetryPolicy(max_attempts=3, base_delay=0.01,
                             total_deadline=10)
  assert client.request_sync(0, 'get', idempotent=True,
                             retry_policy=policy) == 42
  assert trace.counter_get('fault.rpc.client.request') == 1
  assert trace.counter_get('resilience.retry') == 1


def test_rpc_non_idempotent_never_retries(rpc_pair):
  server, client = rpc_pair
  calls = []
  server.register('incr', lambda: calls.append(1) or len(calls))
  faults.arm('rpc.client.request', 'raise', exc=ConnectionError, times=1)
  with pytest.raises(ConnectionError):
    client.request_sync(0, 'incr')
  assert calls == []
  faults.disarm()
  assert client.request_sync(0, 'incr') == 1
  with pytest.raises(ValueError, match='idempotent'):
    client.request_sync(0, 'incr', retry_policy=gdist.RetryPolicy())


def test_rpc_response_fault_site_retries_idempotent(rpc_pair):
  server, client = rpc_pair
  server.register('get', lambda: 'payload')
  faults.arm('rpc.client.response', 'raise', exc=ConnectionError, times=1)
  assert client.request_sync(
      0, 'get', idempotent=True,
      retry_policy=gdist.RetryPolicy(max_attempts=3, base_delay=0.01,
                                     total_deadline=10)) == 'payload'
  assert trace.counter_get('fault.rpc.client.response') == 1


def test_rpc_server_hang_detected_by_heartbeat(rpc_pair):
  """A hung (not dead) server: every dispatch is delayed far past the
  probe timeout, and the rank is declared dead in seconds."""
  server, client = rpc_pair
  server.register('heartbeat', lambda: {'ok': True})
  assert client.request_sync(0, 'heartbeat', idempotent=True,
                             retry_policy=gdist.NO_RETRY)['ok']
  faults.arm('rpc.server.dispatch', 'delay', delay=30.0)

  def probe(rank):
    client.request_sync(rank, 'heartbeat', timeout=0.3, idempotent=True,
                        retry_policy=gdist.NO_RETRY)

  hb = gdist.Heartbeat([0], probe, interval=0.1, miss_threshold=2)
  t0 = time.monotonic()
  hb.start()
  try:
    deadline = time.monotonic() + 15
    while not hb.is_dead(0) and time.monotonic() < deadline:
      time.sleep(0.05)
    assert hb.is_dead(0)
    assert time.monotonic() - t0 < 10
  finally:
    hb.stop()
    faults.disarm()


# ----------------------------------------------------- channel diagnostics


def test_mp_channel_timeout_carries_context():
  ch = gtt.channel.MpChannel(capacity=7)
  with pytest.raises(gtt.channel.QueueTimeoutError) as ei:
    ch.recv(timeout_ms=20)
  msg = str(ei.value)
  assert 'mp channel' in msg and '20ms' in msg
  assert 'capacity=7' in msg and 'received_so_far=0' in msg


def test_shm_channel_timeout_carries_context():
  ch = gtt.channel.ShmChannel(shm_size=1 << 16)
  try:
    ch.send({'a': np.arange(3)})
    ch.recv(timeout_ms=100)
    with pytest.raises(gtt.channel.QueueTimeoutError) as ei:
      ch.recv(timeout_ms=20)
    msg = str(ei.value)
    assert 'shm channel' in msg and '20ms' in msg
    assert 'received_so_far=1' in msg and 'shmid=' in msg
  finally:
    ch.close()


def test_remote_channel_timeout_carries_context():
  block = threading.Event()

  def never_answers(rank, pid):
    block.wait(30)
    return None, True

  ch = gtt.channel.RemoteReceivingChannel([0, 1], [5, 6], prefetch_size=1,
                                          request_fn=never_answers)
  try:
    with pytest.raises(gtt.channel.QueueTimeoutError) as ei:
      ch.recv(timeout_ms=50)
    msg = str(ei.value)
    assert 'remote channel' in msg and '50ms' in msg
    assert 'servers=[0, 1]' in msg and 'live_pairs=2' in msg
    assert 'received_so_far=0' in msg
  finally:
    block.set()
    ch.stop(join=True)


def test_shm_send_drop_fault_site():
  ch = gtt.channel.ShmChannel(shm_size=1 << 16)
  try:
    faults.arm('channel.shm.send', 'drop', times=1)
    ch.send({'a': np.arange(3)})        # dropped
    ch.send({'b': np.arange(4)})        # delivered
    assert list(ch.recv(timeout_ms=200)) == ['b']
    with pytest.raises(gtt.channel.QueueTimeoutError):
      ch.recv(timeout_ms=20)
    assert trace.counter_get('fault.channel.shm.send') == 1
  finally:
    ch.close()


# ---------------------------------------------------- server-side invariants


def _tiny_dataset(n=16):
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(np.stack([rows, cols]), num_nodes=n)
  ds.init_node_labels(np.arange(n) % 2)
  return ds


def _node_cfg(batch_size=4, seed=None):
  return gtt.sampler.SamplingConfig(
      gtt.sampler.SamplingType.NODE, [2], batch_size, False, False, False,
      False, False, False, 'out', seed)


def test_server_fetch_and_create_fault_sites():
  server = gdist.DistServer(_tiny_dataset())
  try:
    faults.arm('server.create_producer', 'raise', times=1)
    with pytest.raises(faults.FaultError):
      server.create_sampling_producer(np.arange(8), _node_cfg())
    faults.disarm()
    pid = server.create_sampling_producer(np.arange(8), _node_cfg())
    server.start_new_epoch_sampling(pid)
    faults.arm('server.fetch', 'raise', times=1)
    with pytest.raises(faults.FaultError):
      server.fetch_one_sampled_message(pid)
    faults.disarm()
    got, deadline = 0, time.monotonic() + 60
    while time.monotonic() < deadline:
      msg, end = server.fetch_one_sampled_message(pid, timeout_ms=500)
      got += msg is not None
      if end:
        break
    assert got == server.producer_num_expected(pid) == 2
  finally:
    server.exit()


def test_destroy_sampling_producer_idempotent_and_releases_shm():
  server = gdist.DistServer(_tiny_dataset())
  base = live_channel_count()
  try:
    pid = server.create_sampling_producer(np.arange(8), _node_cfg(),
                                          num_workers=1, worker_key='k')
    # a repeated worker_key returns its producer
    assert server.create_sampling_producer(np.arange(8), _node_cfg(),
                                           worker_key='k') == pid
    procs = list(server._producers[pid]._procs)
    assert live_channel_count() == base + 1
    server.destroy_sampling_producer(pid)
    assert live_channel_count() == base          # ring released
    assert not any(p.is_alive() for p in procs)  # workers joined
    server.destroy_sampling_producer(pid)        # idempotent no-op
    server.destroy_sampling_producer(999999)     # unknown id no-op
    assert server.exit() and server.exit()       # exit idempotent too
    assert live_channel_count() == base
  finally:
    server.exit()


def test_idle_producer_reaped_after_client_disconnect():
  server = gdist.DistServer(_tiny_dataset(), producer_ttl=0.3)
  base = live_channel_count()
  try:
    pid = server.create_sampling_producer(np.arange(8), _node_cfg(),
                                          num_workers=1)
    assert live_channel_count() == base + 1
    deadline = time.monotonic() + 30
    while live_channel_count() > base and time.monotonic() < deadline:
      time.sleep(0.05)
    assert live_channel_count() == base
    assert trace.counter_get('resilience.producer_reaped') == 1
    assert pid not in server._producers
    assert pid not in server._last_active
  finally:
    server.exit()


# ----------------------------------------------- producer health and replay


def _mp_loader(ds, n, **kw):
  return gdist.MpDistNeighborLoader(ds, [2], np.arange(n), batch_size=4,
                                    shuffle=False, num_workers=1, seed=0,
                                    **kw)


def test_check_worker_health_detects_dead_worker():
  loader = _mp_loader(_tiny_dataset(), 16, max_worker_restarts=0)
  try:
    loader.producer.check_worker_health()   # healthy: no-op
    loader.producer._procs[0].terminate()
    loader.producer._procs[0].join(timeout=10)
    with pytest.raises(RuntimeError, match='restart budget'):
      loader.producer.check_worker_health()
  finally:
    loader.shutdown()


def _fingerprints(loader):
  """{seed block: the batch's arrays} of one epoch."""
  out = {}
  for b in loader:
    key = tuple(b.batch.numpy()[:b.batch_size].tolist())
    out[key] = [b.node.numpy().copy(), b.edge_index.numpy().copy(),
                b.edge_mask.numpy().copy(), b.y.numpy().copy()]
  return out


def test_worker_kill_bit_identical_replay(monkeypatch):
  """Kill each sampling worker at its 4th batch: the producer respawns it
  with its key stream fast-forwarded (``resume_calls``) and it replays
  its unsent batches; the epoch equals an undisturbed one bit for bit."""
  rng = np.random.default_rng(1)
  n = 40
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(np.stack([rng.integers(0, n, 240), rng.integers(0, n, 240)]),
                num_nodes=n)
  ds.init_node_labels(np.arange(n) % 3)

  def loader(**kw):
    return gdist.MpDistNeighborLoader(ds, [3, 2], np.arange(n),
                                      batch_size=4, shuffle=True,
                                      num_workers=2, seed=0, **kw)

  ref_loader = loader()
  try:
    reference = _fingerprints(ref_loader)
    assert len(reference) == len(ref_loader) == 10
  finally:
    ref_loader.shutdown()
  # the spawned workers parse GLT_FAULTS at import: each incarnation
  # dies at its 4th attempted batch; a respawn starts at batch 3 and
  # never reaches 4 hits
  monkeypatch.setenv('GLT_FAULTS',
                     'producer.worker.batch:exit:after=3,times=1,code=17')
  faulted = loader(max_worker_restarts=4)
  faulted.health_check_interval_ms = 500
  try:
    replayed = _fingerprints(faulted)
    assert trace.counter_get('resilience.worker_restart') == 2
  finally:
    faulted.shutdown()
  assert replayed.keys() == reference.keys()
  for key, arrays in reference.items():
    for a, b in zip(arrays, replayed[key]):
      np.testing.assert_array_equal(a, b, err_msg=str(key))
