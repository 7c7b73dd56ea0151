"""The port's sharded serving stores against the JAX package's.

Mirrors ``tests/test_serving.py:432`` (``DistEmbeddingStore``): the same
materialized table partitioned over P shards (contiguous row blocks, a
replicated hot-embedding cache chosen by ``split_ratio`` and
``hotness``) on the conftest's CPU mesh and on a one-process CPU
``ShardMesh``; every padded bucket's rows and the cache counters equal,
exactly. Then the port's ``EmbeddingMaterializer.dist_embedding_store``
behind the ``ServingEngine``: buckets must be multiples of the shard
count, answers equal the single-replica table, pad rows never served,
the counters count valid ids only. And ``RotatingShardedStore`` /
``RotationScheduler`` (``tests/test_rotation.py:40-211``): lookups equal
JAX's store and the version table (warm prefix, mmap tail, pads), the
same per-shard spill layout, rotations under live threaded traffic
answered from one version each (version-tagged tables) and exactly
once, one-rotation-deep disk retention, a failed shard swap keeping the
previous version serving, the scheduler's interval and staleness
triggers, and a failed build kept serving.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch.serving import (DistEmbeddingStore,
                                          EmbeddingMaterializer,
                                          RotatingShardedStore,
                                          RotationScheduler, ServingEngine)

from test_torch_serving import F, N, _torch_dataset

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

STATS = ('hits', 'misses', 'unique_misses', 'overflow', 'lookups')


def jmesh(p):
  import jax
  from jax.sharding import Mesh
  return Mesh(np.array(jax.devices()[:p]), ('g',))


def _table(n_pad=96, f=5, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (n_pad, f)).astype(np.float32)


@pytest.mark.parametrize('p,kw', [
    (4, dict(split_ratio=0.3)), (2, dict(cache_rows=10, bucket_frac=None)),
    (4, dict(bucket_frac=0.5, wire_dtype='bfloat16'))])
def test_dist_embedding_store_equals_jax(p, kw):
  table = _table()
  hot = np.random.default_rng(3).random(N)
  jst = glt.serving.DistEmbeddingStore.build(table, jmesh(p), hotness=hot,
                                             num_nodes=N, **kw)
  tst = DistEmbeddingStore.build(torch.as_tensor(table),
                                 gdist.ShardMesh(p, 'cpu'), hotness=hot,
                                 num_nodes=N, **kw)
  assert tst.granularity == jst.granularity == p
  assert tst.num_nodes == jst.num_nodes == N
  assert tst.feature_dim == jst.feature_dim == 5
  rng = np.random.default_rng(1)
  for cap in (16, 32):
    ids = np.full(cap, -1, np.int64)
    n = cap - 5
    ids[:n] = rng.integers(0, N, n)
    mask = ids >= 0
    want = jst.fetch(jst.lookup(ids, mask))
    got = tst.fetch(tst.lookup(ids, mask))
    assert got.shape == (cap, 5)
    np.testing.assert_array_equal(got, want)
  js = jst.df.stats()
  ts = tst.publish_stats()
  assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
  assert tst.df.stats()['lookups'] == 0      # published: cleared
  with pytest.raises(AssertionError, match='multiple'):
    tst.lookup(np.zeros(p + 1, np.int64), np.ones(p + 1, bool))
  with pytest.raises(NotImplementedError, match='immutable'):
    tst.update_rows([0], table[:1])


def test_more_shards_than_rows_keeps_a_dummy_row():
  table = _table(3, 4)
  jst = glt.serving.DistEmbeddingStore.build(table, jmesh(4))
  tst = DistEmbeddingStore.build(table, gdist.ShardMesh(4, 'cpu'))
  ids = np.array([0, 1, 2, -1, 2, 1, 0, 0])
  np.testing.assert_array_equal(tst.fetch(tst.lookup(ids, ids >= 0)),
                                jst.fetch(jst.lookup(ids, ids >= 0)))


def test_materializer_dist_store_behind_the_engine():
  tds = _torch_dataset()
  model = gtt.models.GraphSAGE(F, 8, 4, num_layers=2, device='cpu',
                               generator=torch.Generator().manual_seed(0)
                               ).eval()
  mat = EmbeddingMaterializer(tds, model, block_size=32, chunk_size=4)
  emb = mat.materialize().numpy().copy()
  assert emb.shape[0] == 96                   # block padding past N = 90
  hot = np.diff(tds.graph.topo.indptr).astype(np.float64)[:N]
  store = mat.dist_embedding_store(gdist.ShardMesh(4, 'cpu'),
                                   split_ratio=0.3, hotness=hot)
  assert store.granularity == 4 and store.num_nodes == N
  with pytest.raises(ValueError, match='multiple'):
    ServingEngine(store, buckets=(6,))
  engine = ServingEngine(store, buckets=(16, 32), max_wait_ms=1.0)
  rng = np.random.default_rng(1)
  with engine:
    for _ in range(3):
      ids = rng.integers(0, N, 11)
      np.testing.assert_array_equal(engine.lookup(ids), emb[ids])
  s = store.publish_stats()
  assert s['lookups'] == 3 * 11 and s['hits'] > 0
  with pytest.raises(RuntimeError, match='materialize'):
    EmbeddingMaterializer(tds, model, block_size=32).dist_embedding_store(
        gdist.ShardMesh(2, 'cpu'))


# ----------------------------------------------------------- rotation
# (tests/test_rotation.py:40-211 on the port, rows returned on the CPU)

RN, RF = 2000, 8
V_TAG = 100000.0   # a version tag in every row: a torn read shows


def table_for(v):
  return ((np.arange(RN, dtype=np.float32)[:, None] + V_TAG * v)
          * np.ones((1, RF), np.float32))


def make_store(tmp, shards=4, warm_rows=64):
  return RotatingShardedStore(tmp, shards, table_for(0),
                              warm_rows=warm_rows, device='cpu')


def versions_of(rows, ids):
  return np.round((rows[:, 0] - ids) / V_TAG).astype(int)


def counters():
  return gtt.metrics.snapshot()['counters']


def test_rotating_store_surface_equals_jax(tmp_path):
  store = make_store(str(tmp_path / 't'))
  jstore = glt.serving.RotatingShardedStore(str(tmp_path / 'j'), 4,
                                            table_for(0), warm_rows=64)
  assert store.version == 0 and store.granularity == 1
  assert store.num_nodes == RN and store.feature_dim == RF
  ids = np.array([0, 1, 63, 64, 499, 500, 1999, -1], np.int64)
  mask = ids >= 0
  rows = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(rows, np.asarray(jstore.fetch(
      jstore.lookup(ids, mask))))
  np.testing.assert_array_equal(rows[:-1], table_for(0)[ids[:-1]])
  assert not rows[-1].any()
  for i in range(4):
    a = tmp_path / 't' / 'v0000' / f'shard_{i:02d}'
    b = tmp_path / 'j' / 'v0000' / f'shard_{i:02d}'
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
  with pytest.raises(NotImplementedError, match='rotat'):
    store.update_rows(np.array([0]), np.zeros((1, RF), np.float32))
  assert store.rotate(lambda: torch.as_tensor(table_for(1))) == 1
  rows2 = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(rows2[:-1], table_for(1)[ids[:-1]])
  with pytest.raises(ValueError, match='version table'):
    store.install_version(np.zeros((RN - 1, RF), np.float32))
  assert store.version == 1


def test_rotation_under_live_traffic_exactly_once(tmp_path):
  c0 = counters()
  store = make_store(str(tmp_path))
  engine = ServingEngine(store, buckets=(16, 64), max_wait_ms=0.5)
  stop_t = time.perf_counter() + 1.6
  errors, torn, counts = [], [], []

  def client(seed):
    rng = np.random.default_rng(seed)
    n_ok = 0
    try:
      while time.perf_counter() < stop_t:
        ids = rng.integers(0, RN, 8)
        vs = np.unique(versions_of(engine.lookup(ids), ids))
        if vs.size != 1:
          torn.append(vs)
        n_ok += 1
      counts.append(n_ok)
    except BaseException as e:  # noqa: BLE001
      errors.append(e)

  with engine:
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for th in threads:
      th.start()
    for v in (1, 2):
      time.sleep(0.4)
      assert store.rotate(lambda _v=v: table_for(_v)) == v
    for th in threads:
      th.join()
  assert not errors, errors[:1]
  assert not torn, torn[:1]
  assert store.version == 2 and sum(counts) > 0
  held = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith('v'))
  assert held == ['v0001', 'v0002'], held
  c1 = counters()
  assert c1.get('serving.rotations', 0) - \
      c0.get('serving.rotations', 0) == 3
  assert c1.get('serving.requests', 0) - \
      c0.get('serving.requests', 0) == sum(counts)
  assert gtt.metrics.snapshot()['histograms'][
      'serving.rotation_swap_ms']['count'] >= 3


class _FailingSwap(RotatingShardedStore):
  """The ``serving.rotate`` fault, armed: the ``fail_at``-th shard swap
  raises."""
  fail_at = None
  seen = 0

  def _rotate_fault(self):
    self.seen += 1
    if self.fail_at is not None and self.seen == self.fail_at:
      raise RuntimeError('injected swap fault')


def test_failed_shard_swap_serves_previous_version(tmp_path):
  store = _FailingSwap(str(tmp_path), 4, table_for(0), warm_rows=64,
                       device='cpu')
  engine = ServingEngine(store, buckets=(16, 64), max_wait_ms=0.5)
  stop_t = time.perf_counter() + 1.0
  errors, bad_version, served = [], [], []

  def client():
    rng = np.random.default_rng(11)
    n_ok = 0
    try:
      while time.perf_counter() < stop_t:
        ids = rng.integers(0, RN, 8)
        vs = np.unique(versions_of(engine.lookup(ids), ids))
        if vs.tolist() != [0]:
          bad_version.append(vs)
        n_ok += 1
      served.append(n_ok)
    except BaseException as e:  # noqa: BLE001
      errors.append(e)

  with engine:
    th = threading.Thread(target=client)
    th.start()
    store.seen, store.fail_at = 0, 3      # the third shard of the pass
    with pytest.raises(RuntimeError, match='injected'):
      store.rotate(lambda: table_for(7))
    store.fail_at = None
    th.join()
  assert store.version == 0
  assert not errors and not bad_version, (errors[:1], bad_version[:1])
  assert sum(served) > 0
  assert store.rotate(lambda: table_for(2)) == 1
  rows = store.fetch(store.lookup(np.arange(4), np.ones(4, bool)))
  np.testing.assert_array_equal(versions_of(rows, np.arange(4)),
                                np.full(4, 2))


def test_rotation_scheduler_interval_and_staleness(tmp_path):
  c0 = counters()
  store = make_store(str(tmp_path), shards=2)
  built = []

  def build():
    built.append(len(built) + 1)
    return table_for(built[-1])

  stale = {'flag': False}
  sched = RotationScheduler(store, build, interval_s=0.25,
                            staleness_fn=lambda: stale['flag'],
                            poll_s=0.05).start()
  deadline = time.perf_counter() + 5.0
  while sched.rotations < 2 and time.perf_counter() < deadline:
    time.sleep(0.05)
  assert sched.rotations >= 2
  n0 = sched.rotations
  stale['flag'] = True
  deadline = time.perf_counter() + 5.0
  while sched.rotations == n0 and time.perf_counter() < deadline:
    time.sleep(0.02)
  stale['flag'] = False
  assert sched.rotations > n0
  sched.stop()
  n_stopped = sched.rotations
  time.sleep(0.4)
  assert sched.rotations == n_stopped
  assert store.version == n_stopped
  c1 = counters()
  assert c1.get('serving.rotations', 0) - \
      c0.get('serving.rotations', 0) == n_stopped + 1
  with pytest.raises(ValueError, match='trigger'):
    RotationScheduler(store, build)
  with pytest.raises(ValueError, match='interval_s'):
    RotationScheduler(store, build, interval_s=0)


def test_rotation_scheduler_failed_build_keeps_serving(tmp_path):
  c0 = counters()
  store = make_store(str(tmp_path), shards=2)
  calls = []

  def build():
    calls.append(1)
    if len(calls) == 1:
      raise RuntimeError('build failed')
    return table_for(5)

  sched = RotationScheduler(store, build, interval_s=10.0, poll_s=0.02)
  sched.rotate_now()
  sched.start()
  deadline = time.perf_counter() + 5.0
  while sched.rotations < 1 and time.perf_counter() < deadline:
    rows = store.fetch(store.lookup(np.arange(8), np.ones(8, bool)))
    assert np.unique(versions_of(rows, np.arange(8))).size == 1
    time.sleep(0.01)
  sched.stop()
  assert sched.failures == 1 and sched.rotations == 1
  assert store.version == 1 and sched.last_error is None
  assert counters().get('serving.rotation_errors', 0) - \
      c0.get('serving.rotation_errors', 0) == 1
