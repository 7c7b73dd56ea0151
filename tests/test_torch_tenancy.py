"""The port's multi-tenant plane against the JAX package's, on the CPU.

Mirrors ``tests/test_tenancy.py``: the tenancy classes are the JAX
module's host-only Python, copied, so the same request schedule through
JAX's and the port's ``AdmissionController`` gives the same grants,
rejections and snapshots, the same tickets queued in both
``WeightedFairScheduler``s are granted in the same order, and a
``TenantRejection``'s wire payload reads the same both ways. Then the
port's server with ``tenancy=`` in this process: a rejection crosses the
port's RPC as its typed class, the in-flight throttle absorbed by
``with_backpressure`` until a fetch drains it, an exhausted budget
failing loudly, three tenants' contending ``RemoteScanTrainer`` epochs
bit-identical to a solo one, a per-tenant ``producer_ttl`` reaping only
its tenant, and the remote loaders' tenant producers.
"""
import threading
import time

import numpy as np
import pytest
import torch

from graphlearn_tpu.distributed import tenancy as jten
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.distributed import tenancy as tten
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

gdist = gtt.distributed
N = 38          # 38 seeds / bs 4: 10 batches, a ragged tail batch of 2
BS = 4
K = 4           # chunks of 4, 4 and a tail chunk of 2
C = 3
FANOUTS = [2, 2]


def counter(name):
  return metrics.snapshot()['counters'].get(name, 0)


def make_dataset(n=N):
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(np.stack([rows, cols]), num_nodes=n)
  ds.init_node_features(np.arange(n, dtype=np.float32)[:, None] *
                        np.ones((1, 4), np.float32))
  ds.init_node_labels(np.arange(n) % C)
  return ds


@pytest.fixture
def server():
  """``start(dataset, **kw) -> DistServer``: an in-process server behind
  the port's RPC, the client connected; both shut down after."""
  started = []

  def start(ds, **kw):
    host, port = gdist.init_server(1, 1, 0, ds, **kw)
    gdist.init_client(1, 1, 0, [(host, port)])
    started.append(True)
    return gdist.get_server()

  yield start
  if started:
    gdist.shutdown_client()
    gdist.wait_and_shutdown_server(timeout=30)


def block_cfg(seed=0):
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  return SamplingConfig(SamplingType.NODE, FANOUTS, BS, False, False,
                        False, True, False, False, 'out', seed)


def model(seed=0):
  return gtt.models.GraphSAGE(4, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def trainer(m, seeds=None, ranks=0, **opt_kw):
  opts = gdist.RemoteDistSamplingWorkerOptions(server_rank=ranks, **opt_kw)
  return gdist.RemoteScanTrainer(
      FANOUTS, np.arange(N) if seeds is None else seeds, m, C,
      batch_size=BS, chunk_size=K, seed=0, worker_options=opts,
      device='cpu')


# ---------------------------------------------------------- the classes


@pytest.mark.parametrize('name', ['TenantRejection', 'TenantQuotaExceeded',
                                  'TenantThrottled'])
def test_rejection_wire_payload_reads_both_ways(name):
  jcls, tcls = getattr(jten, name), getattr(tten, name)
  assert tcls.WIRE_TYPE == jcls.WIRE_TYPE == name
  kw = dict(quota={'producers': 2, 'max_producers': 2}, retry_after=0.5)
  je = jcls('trainA', 'producers', 'at quota', **kw)
  te = tcls('trainA', 'producers', 'at quota', **kw)
  assert je.to_wire() == te.to_wire()
  assert str(je) == str(te)
  back = tcls.from_wire(je.to_wire())
  assert type(back) is tcls and back.to_wire() == je.to_wire()
  assert jcls.from_wire(te.to_wire()).to_wire() == te.to_wire()
  assert back.retryable
  # never a dead-server class: failover and blind retry must ignore it
  assert not isinstance(te, (ConnectionError, TimeoutError, OSError))
  starved = tten.TenantStarvedError('fetch', te, 3.5)
  jstarved = jten.TenantStarvedError('fetch', je, 3.5)
  assert str(starved) == str(jstarved)
  assert starved.tenant == 'trainA' and starved.quota['producers'] == 2


def test_spec_validation_matches_jax():
  assert tten.PRIORITY_CLASSES == jten.PRIORITY_CLASSES
  for mod in (jten, tten):
    with pytest.raises(ValueError, match='priority'):
      mod.TenantSpec(tenant='x', priority='vip')
    with pytest.raises(ValueError, match='weight'):
      mod.TenantSpec(tenant='x', weight=0.0)
  assert tten.TenancyConfig().sched_timeout == jten.TenancyConfig(
  ).sched_timeout


def _admission_schedule(mod):
  """One fixed schedule of admission calls; each call's outcome (its
  return or the rejection's class, resource, message and quota) and the
  final snapshots."""
  cfg = mod.TenancyConfig(specs=[
      mod.TenantSpec(tenant='a', max_producers=2, max_ring_bytes=100),
      mod.TenantSpec(tenant='b', priority='bulk', weight=0.5,
                     max_inflight_bytes=10, producer_ttl=2.0)],
      default_spec=mod.TenantSpec(producer_ttl=7.0))
  adm = mod.AdmissionController(cfg)
  log = []

  def call(fn, *a, **kw):
    try:
      log.append(('ok', fn(*a, **kw)))
    except mod.TenantRejection as e:
      log.append((type(e).__name__, e.resource, e.message, e.quota,
                  e.retry_after))

  call(adm.admit_producer, 'a', 0, ring_bytes=60)
  call(adm.admit_producer, 'a', 1, ring_bytes=60)       # ring quota
  call(adm.admit_producer, 'a', 2, ring_bytes=40)
  call(adm.admit_producer, 'a', 3)                      # producer quota
  call(adm.admit_producer, 'c', 4, priority='interactive', weight=3.0)
  call(adm.admit_producer, 'b', 5)
  call(adm.check_inflight, 'b')
  adm.charge_inflight('b', 12)
  call(adm.check_inflight, 'b')                         # throttled
  adm.release_inflight('b', 5)
  call(adm.check_inflight, 'b')
  call(adm.release_producer, 0)
  call(adm.release_producer, 5, reaped=True)
  call(adm.admit_producer, 'a', 6, ring_bytes=10)
  call(adm.register, 'b', weight=2.0)
  log.append(('tenant_of', adm.tenant_of(5), adm.tenant_of(99)))
  log.append(('ttl', adm.ttl_for_pid(5, None), adm.ttl_for_pid(4, 1.0),
              adm.min_ttl(None), adm.min_ttl(0.5)))
  log.append(('describe', adm.describe_pid(5)))
  return log, adm.snapshot_all()


def _plain(v):
  # a returned TenantSpec compares by its fields across the packages
  return vars(v) if hasattr(v, '__dataclass_fields__') else v


def test_admission_schedule_matches_jax():
  jlog, jsnap = _admission_schedule(jten)
  tlog, tsnap = _admission_schedule(tten)
  kinds = [e[0] for e in tlog]
  assert kinds.count('TenantQuotaExceeded') == 2
  assert kinds.count('TenantThrottled') == 1
  assert [tuple(map(_plain, e)) for e in tlog] == \
      [tuple(map(_plain, e)) for e in jlog]
  assert tsnap == jsnap


def _grant_order(mod, tickets, quantum=2.0):
  """The scheduler's grant order over queued tickets, drained by
  ``_pick`` alone (the drain thread stopped first)."""
  adm = mod.AdmissionController(mod.TenancyConfig())
  adm.register('heavy', priority='training', weight=3.0)
  adm.register('light', priority='training', weight=1.0)
  adm.register('bulk', priority='bulk', weight=5.0)
  adm.register('ui', priority='interactive', weight=1.0)
  sched = mod.WeightedFairScheduler(adm, quantum=quantum, timeout=1.0)
  sched.close()
  order, who = [], {}
  with sched._lock:
    for tenant, cost in tickets:
      prio = mod._priority_index(adm.spec(tenant).priority)
      t = mod._Ticket(cost)
      who[id(t)] = tenant
      sched._queues[prio].setdefault(tenant, []).append(t)
    while True:
      t = sched._pick()
      if t is None:
        break
      order.append(who[id(t)])
  return order, dict(sched._deficit), dict(sched._rr)


@pytest.mark.parametrize('quantum', [1.0, 2.0, 4.0])
def test_scheduler_grant_order_matches_jax(quantum):
  rng = np.random.default_rng(int(quantum))
  tenants = ['heavy', 'light', 'bulk', 'ui']
  tickets = [(tenants[i], float(c)) for i, c in
             zip(rng.integers(0, 4, 40), rng.integers(1, 6, 40))]
  jorder = _grant_order(jten, tickets, quantum)
  torder = _grant_order(tten, tickets, quantum)
  assert torder == jorder
  # strict priority: every interactive grant precedes every other
  order = torder[0]
  n_ui = order.count('ui')
  assert order[:n_ui] == ['ui'] * n_ui and order[-1] == 'bulk'


def test_scheduler_weighted_fairness_and_priority_preemption():
  """Two contending training tenants split grants by weight; an
  interactive tenant arriving later jumps the queued training backlog."""
  adm = tten.AdmissionController(tten.TenancyConfig())
  adm.register('heavy', priority='training', weight=3.0)
  adm.register('light', priority='training', weight=1.0)
  adm.register('ui', priority='interactive', weight=1.0)
  sched = tten.WeightedFairScheduler(adm, quantum=2.0, timeout=10.0)
  try:
    order = []
    olock = threading.Lock()

    def pump(tenant, n):
      for _ in range(n):
        def work():
          with olock:
            order.append(tenant)
          time.sleep(0.002)
        sched.run(tenant, 4.0, work)

    th = [threading.Thread(target=pump, args=('heavy', 30)),
          threading.Thread(target=pump, args=('light', 30))]
    for t in th:
      t.start()
    time.sleep(0.05)
    ui = threading.Thread(target=pump, args=('ui', 5))
    ui.start()
    for t in th + [ui]:
      t.join()
    assert sched.served == {'heavy': 120.0, 'light': 120.0, 'ui': 20.0}
    first_ui = order.index('ui')
    assert order[first_ui:first_ui + 5] == ['ui'] * 5
    window = order[4:24]
    assert window.count('heavy') > window.count('light')
  finally:
    sched.close()


def test_backpressure_budget_exhaustion_fails_loudly():
  calls = []

  def always_throttled():
    calls.append(1)
    raise tten.TenantThrottled('bulk1', 'inflight_bytes', 'throttled',
                               quota={'inflight_bytes': 9},
                               retry_after=0.01)

  before = counter('tenant.starved')
  with pytest.raises(tten.TenantStarvedError) as ei:
    tten.with_backpressure(always_throttled, describe='produce',
                           budget_s=0.05, base_delay=0.01)
  assert ei.value.tenant == 'bulk1'
  assert ei.value.quota == {'inflight_bytes': 9}
  assert len(calls) >= 2          # it did retry before giving up
  assert counter('tenant.starved') == before + 1


# ------------------------------------------------------------ the server


def test_quota_rejection_crosses_the_rpc_typed(server):
  """An over-quota create answers ``TenantQuotaExceeded`` through the
  port's RPC, quota aboard; the slot frees on destroy."""
  srv = server(make_dataset(), tenancy=tten.TenancyConfig(specs=[
      tten.TenantSpec(tenant='trainA', max_producers=1)]))
  seeds = np.arange(N)
  before = counter('tenant.admit_rejections')
  pid = gdist.request_server(0, 'create_block_producer', seeds, block_cfg(),
                             None, worker_key='t/a/0', tenant='trainA',
                             priority='training')
  with pytest.raises(tten.TenantQuotaExceeded) as ei:
    gdist.request_server(0, 'create_block_producer', seeds, block_cfg(),
                         None, worker_key='t/a/1', tenant='trainA')
  assert ei.value.tenant == 'trainA' and ei.value.resource == 'producers'
  assert ei.value.quota['max_producers'] == 1 and ei.value.retryable
  assert counter('tenant.admit_rejections') == before + 1
  snap = gdist.request_server(0, 'get_metrics')['tenants']
  assert snap['trainA']['producers'] == 1
  assert srv._admission.snapshot('trainA') == snap['trainA']
  gdist.request_server(0, 'destroy_block_producer', pid)
  assert gdist.request_server(
      0, 'create_block_producer', seeds, block_cfg(), None,
      worker_key='t/a/2', tenant='trainA') != pid


def test_inflight_throttle_then_drain(server):
  """A tenant at its in-flight quota is throttled over the wire;
  ``with_backpressure`` waits visibly (``tenant.backpressure_ms``) and
  the same produce succeeds once a fetch drains the staged frame."""
  srv = server(make_dataset(), tenancy=tten.TenancyConfig(specs=[
      tten.TenantSpec(tenant='trainA', max_inflight_bytes=1)]))
  pid = gdist.request_server(0, 'create_block_producer', np.arange(N),
                             block_cfg(), None, worker_key='t/bp/0',
                             tenant='trainA')
  gdist.request_server(0, 'block_produce', pid, 0, 0, K)
  staged = srv._admission.snapshot('trainA')['inflight_bytes']
  assert staged == srv._block_producers[pid].cached_bytes() > 0
  with pytest.raises(tten.TenantThrottled) as ei:
    gdist.request_server(0, 'block_produce', pid, 0, K, K)
  assert ei.value.resource == 'inflight_bytes'
  assert ei.value.retry_after is not None
  hist = metrics.snapshot()['histograms'].get('tenant.backpressure_ms')
  waits0 = hist['count'] if hist else 0

  def drain():
    time.sleep(0.25)
    gdist.request_server(0, 'block_fetch', pid, 0, 0, K, idempotent=True)

  t = threading.Thread(target=drain)
  t.start()
  assert tten.with_backpressure(
      lambda: gdist.request_server(0, 'block_produce', pid, 0, K, K),
      describe='produce ahead', budget_s=30.0, tenant='trainA')
  t.join()
  hist = metrics.snapshot()['histograms']['tenant.backpressure_ms']
  assert hist['count'] > waits0
  # the fetch is never throttled, and destroy releases what is staged
  assert srv._admission.snapshot('trainA')['inflight_bytes'] > 0
  gdist.request_server(0, 'destroy_block_producer', pid)
  assert srv._admission.snapshot('trainA')['inflight_bytes'] == 0


def test_three_tenants_contending_epochs_bit_identical(server):
  """Two training tenants (weights 2:1) and an interactive one run their
  epochs at once through the weighted-fair lane: each tenant's losses
  and parameters equal a solo run's and its seed coverage is exact."""
  srv = server(make_dataset(), tenancy=tten.TenancyConfig(specs=[
      tten.TenantSpec(tenant='trainA', priority='training', weight=2.0),
      tten.TenantSpec(tenant='trainB', priority='training', weight=1.0),
      tten.TenantSpec(tenant='ui', priority='interactive', weight=1.0)]))
  ref_model = model()
  ref = trainer(ref_model)
  _, ref_losses, _ = ref.run_epoch(ttrain.create_train_state(ref_model))
  ref.shutdown()
  tenants = [('trainA', 'training', 2.0), ('trainB', 'training', 1.0),
             ('ui', 'interactive', 1.0)]
  results, errors = {}, []

  def run(tenant, priority, weight):
    try:
      m = model()
      tr = trainer(m, tenant=tenant, tenant_priority=priority,
                   tenant_weight=weight)
      _, losses, _ = tr.run_epoch(ttrain.create_train_state(m))
      results[tenant] = (losses, sorted(tr.last_epoch_seed_ids.tolist()), m)
      tr.shutdown()
    except BaseException as e:  # noqa: BLE001 - surfaced after the join
      errors.append((tenant, e))

  threads = [threading.Thread(target=run, args=t) for t in tenants]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=300)
  assert not errors, errors
  for tenant, _, _ in tenants:
    losses, cover, m = results[tenant]
    assert torch.equal(losses, ref_losses), tenant
    assert cover == list(range(N)), tenant
    for a, b in zip(ref_model.parameters(), m.parameters()):
      assert torch.equal(a, b)
  got = srv.get_metrics()
  assert all(got['tenant_served'].get(t, 0) > 0 for t, _, _ in tenants)
  assert got['tenants']['ui']['priority'] == 'interactive'
  assert got['tenants']['trainA']['weight'] == 2.0


def test_tenant_ttl_reaps_only_its_tenant(server):
  """A per-tenant ``producer_ttl`` reaps the idle tenant's sampling and
  block producers only (``tenant.reaped.<t>``), no ring is left, the
  live tenant's stream survives, and a reaped handle's error names the
  tenant."""
  from graphlearn_tpu_torch.channel import live_channel_count
  srv = server(make_dataset(), tenancy=tten.TenancyConfig(specs=[
      tten.TenantSpec(tenant='idle', producer_ttl=0.3),
      tten.TenantSpec(tenant='live', producer_ttl=60.0)]))
  seeds, cfg = np.arange(N), block_cfg()
  base = live_channel_count()
  reaped0 = counter('tenant.reaped.idle')
  idle_spid = srv.create_sampling_producer(
      seeds[:8], cfg, num_workers=1, buffer_size=1 << 20,
      worker_key='t/idle/s', tenant='idle')
  idle_bpid = srv.create_block_producer(seeds[:8], cfg, None,
                                        worker_key='t/idle/b',
                                        tenant='idle')
  live_bpid = srv.create_block_producer(seeds, cfg, None,
                                        worker_key='t/live/b',
                                        tenant='live')
  assert live_channel_count() > base
  time.sleep(0.45)
  srv.block_producer_num_batches(live_bpid)
  deadline = time.monotonic() + 10
  while time.monotonic() < deadline and \
      counter('tenant.reaped.idle') < reaped0 + 2:
    srv.reap_idle_producers()
    time.sleep(0.05)
  assert counter('tenant.reaped.idle') == reaped0 + 2
  assert counter('tenant.reaped.live') == 0
  deadline = time.monotonic() + 15
  while time.monotonic() < deadline and live_channel_count() > base:
    time.sleep(0.1)
  assert live_channel_count() == base
  assert srv.block_producer_num_batches(live_bpid) == 10
  with pytest.raises(RuntimeError, match=r"tenant='idle'.*idle-reaped"):
    srv.block_produce(idle_bpid, 0, 0, K)
  with pytest.raises(RuntimeError, match=r"tenant='idle'"):
    srv.fetch_one_sampled_message(idle_spid, timeout_ms=10)
  srv.create_block_producer(seeds[:8], cfg, None, worker_key='t/idle/b2',
                            tenant='idle')


def test_remote_loader_registers_its_tenant(server):
  """The remote loader sends its tenant with each producer; a tenant that
  can never be admitted fails loudly with its quota."""
  from graphlearn_tpu_torch.channel import live_channel_count
  srv = server(make_dataset(), tenancy=tten.TenancyConfig(specs=[
      tten.TenantSpec(tenant='ui', priority='interactive', weight=2.0),
      tten.TenantSpec(tenant='none', max_producers=0)]))
  base = live_channel_count()
  opts = gdist.RemoteDistSamplingWorkerOptions(
      server_rank=0, tenant='ui', tenant_priority='interactive',
      buffer_size=1 << 20)
  loader = gdist.RemoteDistNeighborLoader(FANOUTS, np.arange(16),
                                          batch_size=BS,
                                          worker_options=opts, seed=0,
                                          device='cpu')
  try:
    assert sum(1 for _ in loader) == 4
    snap = srv.get_metrics()['tenants']['ui']
    assert snap['producers'] == 1 and snap['ring_bytes'] == 1 << 20
  finally:
    loader.shutdown()
  assert srv.get_metrics()['tenants']['ui']['producers'] == 0
  starved = gdist.RemoteDistSamplingWorkerOptions(
      server_rank=0, tenant='none', backpressure_budget=0.2,
      buffer_size=1 << 20)
  with pytest.raises(tten.TenantStarvedError, match='max_producers'):
    gdist.RemoteDistNeighborLoader(FANOUTS, np.arange(16), batch_size=BS,
                                   worker_options=starved, seed=0,
                                   device='cpu')
  assert live_channel_count() == base
