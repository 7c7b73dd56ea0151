"""Continuous retuning (``graphlearn_tpu_torch.tune.retune``) against the
JAX package's, and the fault sites this slice adds.

Held exactly: the three drift probes over the port's metric registry
(``program.retrace_budget_exceeded``, ``dist_feature.hits`` /
``misses``, ``serving.total_ms``), step by step beside JAX's over the
same increments; the scheduler's edge latching, driven by the same level
sequences through both packages' ``_fired``; a failed or chaos-killed
shadow retune (the ``tune.shadow_retune`` fault) keeping the previous
config and re-arming; ``stop()`` joining the daemon.

The fault registry: every one of JAX's 22 registered sites is passed by
some ``fault_point`` call in the port, and the four sites added here
behave as JAX's chaos tests require: ``recovery.save`` armed once kills
one snapshot write, the checkpointer degrades to synchronous writes and
the epoch is bit-identical; ``recovery.restore`` armed once on the
newest snapshot falls back to the one before; ``storage.promote`` armed
degrades the tiered epoch to synchronous reads, bit-identical;
``serving.rotate`` armed mid-swap keeps the previous version serving.
"""
import ast
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu import metrics as jmetrics
from graphlearn_tpu.tune import retune as jretune
from graphlearn_tpu.utils import faults as jfaults
from graphlearn_tpu_torch import metrics as tmetrics
from graphlearn_tpu_torch.tune import retune as tretune
from graphlearn_tpu_torch.utils import faults

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
  faults.disarm()
  yield
  faults.disarm()


def _counter(name):
  return tmetrics.snapshot()['counters'].get(name, 0)


# ------------------------------------------------------------ the probes


def test_retrace_overrun_probe_equals_jax():
  j, t = jretune.retrace_overrun_probe(), tretune.retrace_overrun_probe()
  for incs in (0, 1, 0, 2, 0, 0, 3):
    for _ in range(incs):
      jmetrics.inc('program.retrace_budget_exceeded')
      tmetrics.inc('program.retrace_budget_exceeded')
    assert t() is j() is (incs > 0)


def test_hit_rate_decay_probe_equals_jax():
  j = jretune.hit_rate_decay_probe(floor=0.5)
  t = tretune.hit_rate_decay_probe(floor=0.5)
  for hits, misses in ((0, 0), (9, 1), (1, 9), (0, 0), (5, 5), (4, 6)):
    for m in (jmetrics, tmetrics):
      for _ in range(hits):
        m.inc('dist_feature.hits')
      for _ in range(misses):
        m.inc('dist_feature.misses')
    want = hits + misses > 0 and hits / (hits + misses) < 0.5
    assert t() is j() is want


def test_p99_creep_probe_equals_jax():
  tmetrics.reset('serving.total_ms')
  jmetrics.reset('serving.total_ms')
  j = jretune.p99_creep_probe(limit_ms=50.0, min_count=4)
  t = tretune.p99_creep_probe(limit_ms=50.0, min_count=4)
  seq = []
  for values in ([], [500.0], [500.0] * 3, [1.0] * 400):
    for v in values:
      jmetrics.observe('serving.total_ms', v)
      tmetrics.observe('serving.total_ms', v)
    got = t()
    assert got == j()
    seq.append(got)
  assert seq == [False, False, True, False]


# ------------------------------------------------------------- scheduler


def _schedulers(levels, **kw):
  """The same triggers over ``levels`` in both packages."""
  def triggers():
    return {n: (lambda n=n: levels[n]) for n in levels}
  return (jretune.RetuneScheduler(lambda: 'art', lambda a: None,
                                  triggers(), **kw),
          tretune.RetuneScheduler(lambda: 'art', lambda a: None,
                                  triggers(), **kw))


def test_edge_latching_equals_jax():
  levels = {'a': False, 'b': False}
  js, ts = _schedulers(levels)
  script = [('a', True), (None, None), (None, None), ('b', True),
            ('a', False), ('a', True), ('b', False), (None, None),
            ('b', True), ('a', False)]
  fired = []
  for name, value in script:
    if name is not None:
      levels[name] = value
    got = ts._fired()
    assert got == js._fired()
    fired.append(got)
  assert fired == ['a', None, None, 'b', None, 'a', None, None, 'b', None]


def test_raising_probe_is_not_drifted():
  def broken():
    raise RuntimeError('probe bug')
  s = tretune.RetuneScheduler(lambda: 'art', lambda a: None,
                              {'bad': broken, 'ok': lambda: True})
  assert s._fired() == 'ok'
  assert s._fired() is None


def test_chaos_killed_shadow_retune_keeps_previous_and_rearms():
  """The ``tune.shadow_retune`` fault kills an attempt before the shadow
  tune: the previous config stays, the trigger re-arms, the fault is
  counted; disarmed, the next attempt publishes."""
  published = []
  s = tretune.RetuneScheduler(lambda: 'fresh', published.append,
                              {'drift': lambda: True}, initial='old')
  f0 = _counter('tune.drift_triggers')
  with faults.injected('tune.shadow_retune', 'raise', times=1):
    trigger = s._fired()
    s._attempt(trigger)
    _, fired = faults.stats('tune.shadow_retune')
  assert fired == 1
  assert s.current == 'old' and s.failures == 1 and published == []
  assert 'FaultError' in s.last_error
  assert s._fired() == 'drift'               # re-armed by the failure
  s._attempt('drift')
  assert s.current == 'fresh' and s.retunes == 1 and published == ['fresh']
  assert _counter('tune.drift_triggers') == f0 + 2
  assert s._fired() is None                  # sustained: latched


def test_failed_publish_keeps_previous_config():
  def refuse(art):
    raise ValueError('fingerprint mismatch')
  s = tretune.RetuneScheduler(lambda: 'fresh', refuse,
                              {'d': lambda: True}, initial='old')
  s._attempt(s._fired())
  assert s.current == 'old' and s.failures == 1


def test_daemon_publishes_once_per_condition_and_stop_joins():
  level = {'d': False}
  done = threading.Event()
  published = []

  def publish(art):
    published.append(art)
    done.set()

  s = tretune.RetuneScheduler(lambda: len(published), publish,
                              {'d': lambda: level['d']}, poll_s=0.01)
  with pytest.raises(ValueError, match='at least one drift'):
    tretune.RetuneScheduler(lambda: 0, publish, {})
  s.start()
  assert s.start() is s
  level['d'] = True
  assert done.wait(10)
  time.sleep(0.1)
  assert published == [0]                    # sustained: one publish
  thread = s._thread
  s.stop()
  assert not thread.is_alive() and s._thread is None
  s.stop()                                   # idempotent


# ------------------------------------------------------------ the sites


def _fault_point_names():
  names = set()
  for path in (ROOT / 'graphlearn_tpu_torch').rglob('*.py'):
    for node in ast.walk(ast.parse(path.read_text())):
      if isinstance(node, ast.Call) and \
          getattr(node.func, 'id', None) == 'fault_point' and node.args \
          and isinstance(node.args[0], ast.Constant):
        names.add(node.args[0].value)
  return names


def test_every_registered_site_is_passed_in_the_port():
  assert faults.REGISTERED_SITES == jfaults.REGISTERED_SITES
  assert len(faults.REGISTERED_SITES) == 22
  assert _fault_point_names() == set(faults.REGISTERED_SITES)


def test_save_fault_degrades_to_sync_and_restore_fault_falls_back(tmp_path):
  """``recovery.save`` armed once: the first (writer-thread) snapshot
  write dies, the checkpointer degrades to synchronous writes, the epoch
  and its later snapshots are bit-identical. ``recovery.restore`` armed
  once: the newest snapshot fails to load and the resume falls back to
  the one before it (JAX's ``latest()``), still bit-identical."""
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer, snapshot
  from test_torch_recovery import _params, _trainer
  ref, rstate = _trainer()
  _, rlosses, _ = ref.run_epoch(rstate)
  tr, state = _trainer()
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(tr)
  e0, s0 = _counter('checkpoint.save_errors'), _counter(
      'checkpoint.sync_fallback')
  with faults.injected('recovery.save', 'raise', times=1):
    state, losses, _ = tr.run_epoch(state)
    ck.flush()
    _, fired = faults.stats('recovery.save')
  assert fired == 1 and ck.degraded
  assert torch.equal(losses, rlosses)
  for a, b in zip(_params(tr.model), _params(ref.model)):
    assert torch.equal(a, b)
  assert _counter('checkpoint.save_errors') == e0 + 1
  assert _counter('checkpoint.sync_fallback') > s0
  ck.close()
  snaps = snapshot.list_snapshots(str(tmp_path))
  assert [s for _, s, _ in snaps] == [4, 6]
  torn0 = _counter('checkpoint.torn_skipped')
  fresh, template = _trainer(model_seed=9)
  with faults.injected('recovery.restore', 'raise', times=1):
    _, losses2, _ = ChunkCheckpointer(str(tmp_path)).resume_epoch(
        fresh, template)
  assert _counter('checkpoint.torn_skipped') == torn0 + 1
  np.testing.assert_array_equal(losses2, rlosses.numpy())
  for a, b in zip(_params(fresh.model), _params(ref.model)):
    assert torch.equal(a, b)


def test_promote_fault_degrades_the_tiered_epoch(tmp_path):
  from test_torch_storage_scan import _loader, _model, _params, _tiered
  model = _model()
  hbm = gtt.loader.ScanTrainer(_loader(), model, 3, chunk_size=4)
  _, want, _ = hbm.run_epoch(gtt.models.train.create_train_state(model))
  tr, state = _tiered(tmp_path)
  with faults.injected('storage.promote', 'raise'):
    state, losses, _ = tr.run_epoch(state)
    _, fired = faults.stats('storage.promote')
  assert fired >= 1 and tr._stager.degraded
  assert torch.equal(losses, want)
  for a, b in zip(_params(tr.model), _params(model)):
    assert torch.equal(a, b)
  tr.close()


def test_rotate_fault_keeps_the_previous_version_serving(tmp_path):
  """``serving.rotate`` armed on the third shard's swap: the rotation
  raises, version 0 keeps serving every row; disarmed, the next rotation
  publishes."""
  from test_torch_dist_serving import make_store, table_for, versions_of
  store = make_store(str(tmp_path), shards=4)
  ids = np.arange(0, 2000, 97)
  mask = np.ones(ids.shape[0], bool)
  with faults.injected('serving.rotate', 'raise', after=2, times=1):
    with pytest.raises(faults.FaultError):
      store.rotate(lambda: table_for(7))
    _, fired = faults.stats('serving.rotate')
  assert fired == 1 and store.version == 0
  rows = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(versions_of(rows, ids), np.zeros(ids.size))
  assert store.rotate(lambda: table_for(2)) == 1
  rows = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(versions_of(rows, ids),
                                np.full(ids.size, 2))
