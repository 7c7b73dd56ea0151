"""The port's tiered distributed store and scanned epoch.

Mirrors ``tests/test_dist_oversub.py`` (``:105`` to ``:313``) on its
40-node ring over 2 partitions (4 of each partition's 20 rows in the
device hot prefix: 5x oversubscription): ``TieredDistScanTrainer``
bit-identical (losses and parameters, CPU) to the all-device
``DistScanTrainer`` with a ragged tail batch and a tail chunk, over two
epochs and shuffled, with the prologue's exchange plan equal to the JAX
planner's on the same node ids; the staged rows counted; a staging
worker that fails degrades to the synchronous gather, bit-identical, with
``storage.prefetch_miss`` counted; the refusals; ``device_arrays``
refused on an oversubscribed store; the demand-paged per-step ``get``
bit-identical to an all-device store (pads and an all-hot step
included) and equal to the JAX store's rows, with its counters; and
``TieredDistFeature`` / ``spill_partitions`` against the JAX package's
(the same files, ``cpu_get``, ``tier_bytes``). ``planner.plan_exchange``
and ``ExchangePlan`` equal JAX's.
"""
import copy
import os

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.storage import planner as jplanner
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.sampler import CapacityPlanError
from graphlearn_tpu_torch.storage import (DistChunkStager, TieredDistFeature,
                                          TieredDistScanTrainer, planner,
                                          spill_partitions)
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart

from test_torch_dist_scan import jmesh, port_model, ring
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40
P = 2
HOT = 4


def make_loader(tiered, spill_dir=None, num_seeds=38, shuffle=False,
                hot_prefix=HOT):
  parts, feats, node_pb, edge_pb = ring(P, TPart)
  mesh = gdist.ShardMesh(P, 'cpu')
  dg = gdist.DistGraph(P, 0, parts, node_pb, edge_pb)
  if tiered:
    df = TieredDistFeature(P, feats, node_pb, mesh=mesh,
                           spill_dir=spill_dir, hot_prefix_rows=hot_prefix,
                           split_ratio=0.25)
  else:
    df = gdist.DistFeature(P, feats, node_pb, mesh, split_ratio=0.25)
  ds = gdist.DistDataset(P, 0, dg, df, node_labels=np.arange(N) % 3)
  return gdist.DistNeighborLoader(ds, [2, 2], np.arange(num_seeds),
                                  batch_size=2, seed=0, mesh=mesh,
                                  shuffle=shuffle, drop_last=False)


def counter(name):
  return metrics.snapshot()['counters'].get(name, 0)


@pytest.mark.parametrize('shuffle', [False, True])
def test_tiered_dist_scan_bit_identical_two_epochs(tmp_path, shuffle):
  """38 seeds at a global batch of 4: 9 full steps and a masked tail, in
  chunks of 4, 4 and 2."""
  model_a = port_model()
  model_b = copy.deepcopy(model_a)
  ref = gtt.loader.DistScanTrainer(make_loader(False, shuffle=shuffle),
                                   model_a, 3, chunk_size=4)
  tl = make_loader(True, str(tmp_path), shuffle=shuffle)
  trainer = TieredDistScanTrainer(tl, model_b, 3, chunk_size=4)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  for epoch in range(2):
    staged0 = counter('storage.dist_staged_rows')
    with published({0: ref._feat}) as stats_a:
      sa, la, _ = ref.run_epoch(sa)
    with published({0: trainer._feat}) as stats_b:
      sb, lb, _ = trainer.run_epoch(sb)
    assert lb.shape == (10,) and torch.equal(la, lb), epoch
    for x, y in zip(model_a.parameters(), model_b.parameters()):
      assert torch.equal(x, y)
    plan = trainer.last_plan
    assert plan.num_chunks == 3 and plan.hot_prefix_rows == HOT
    assert all(c & (c - 1) == 0 for c in plan.slab_caps())
    staged = plan.stats()['planned_rows']
    assert staged > 0
    assert counter('storage.dist_staged_rows') - staged0 == staged
    # each epoch published its store's counters once, at its end
    assert stats_a == stats_b and stats_a[0]['lookups'] > 0
    # the plan is the JAX planner's over the same replayed ids
    rows = trainer._plan_rows(*trainer._epoch_seeds(
        gtt.random.fold_in(trainer._perm_key, trainer._epochs - 1), 10))
    store = trainer._store
    jp = jplanner.plan_exchange(
        rows.numpy().transpose(1, 0, 2), 4, store.feature_pb,
        store.feat_ids, HOT, cache_ids=store.cache_ids)
    assert jp.slab_caps() == plan.slab_caps()
    for a, b in zip(jp.chunk_rows, plan.chunk_rows):
      np.testing.assert_array_equal(a, b)
  timings = trainer.chunk_timings()
  assert [t['chunk'] for t in timings] == [0, 1, 2]
  assert all(t['stage_ms'] is not None for t in timings)
  assert trainer.slab_bytes > 0
  trainer.close()


def test_failed_staging_degrades_to_the_synchronous_gather(tmp_path):
  model_a = port_model()
  model_b = copy.deepcopy(model_a)
  ref = gtt.loader.DistScanTrainer(make_loader(False), model_a, 3,
                                   chunk_size=4)
  trainer = TieredDistScanTrainer(make_loader(True, str(tmp_path)),
                                  model_b, 3, chunk_size=4,
                                  stage_timeout_s=2.0)

  def fault():
    raise RuntimeError('injected staging fault')
  trainer._stager._stage_fault = fault
  miss0 = counter('storage.prefetch_miss')
  _, la, _ = ref.run_epoch(gtt.models.create_train_state(model_a, 1e-2))
  _, lb, _ = trainer.run_epoch(gtt.models.create_train_state(model_b, 1e-2))
  assert torch.equal(la, lb)
  assert trainer._stager.degraded
  assert counter('storage.prefetch_miss') - miss0 == \
      trainer.last_plan.stats()['planned_rows']
  trainer.close()


def test_crash_resume_of_the_tiered_trainer(tmp_path):
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  model0 = port_model()
  ref_m = copy.deepcopy(model0)
  ref = TieredDistScanTrainer(make_loader(True, str(tmp_path / 'a')), ref_m,
                              3, chunk_size=4)
  with published({0: ref._feat}) as want_stats:
    _, want, _ = ref.run_epoch(gtt.models.create_train_state(ref_m, 1e-2))
  vm = copy.deepcopy(model0)
  victim = TieredDistScanTrainer(make_loader(True, str(tmp_path / 'b')), vm,
                                 3, chunk_size=4)
  ck = ChunkCheckpointer(str(tmp_path / 'ck'), every=1).attach(victim)

  def crash(c, s0, k):
    if c == 2:
      raise RuntimeError('injected')
  victim.stage_hook = crash
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(gtt.models.create_train_state(vm, 1e-2))
  ck.close()
  assert ChunkCheckpointer(str(tmp_path / 'ck')).latest().meta[
      'staging']['planned'] == 3
  fm = copy.deepcopy(model0)
  fresh = TieredDistScanTrainer(make_loader(True, str(tmp_path / 'c')), fm,
                                3, chunk_size=4)
  with published({0: fresh._feat}) as got_stats:
    _, got, _ = ChunkCheckpointer(str(tmp_path / 'ck')).resume_epoch(
        fresh, gtt.models.create_train_state(fm, 1e-2))
  np.testing.assert_array_equal(got, want.numpy())
  for x, y in zip(fm.parameters(), ref_m.parameters()):
    assert torch.equal(x, y)
  # the resumed epoch published the whole epoch's counters
  assert got_stats == want_stats and want_stats[0]['lookups'] > 0
  for t in (ref, victim, fresh):
    t.close()


def test_refusals(tmp_path):
  model = port_model()
  with pytest.raises(CapacityPlanError, match='TieredDistFeature') as ei:
    TieredDistScanTrainer(make_loader(False), model, 3)
  assert 'docs/capacity_plans.md' in str(ei.value)
  with pytest.raises(CapacityPlanError, match='hot_prefix_rows'):
    TieredDistScanTrainer(make_loader(True, str(tmp_path), hot_prefix=0),
                          model, 3)
  parts, feats, node_pb, _ = ring(P, TPart)
  df = TieredDistFeature(P, feats, node_pb, mesh=gdist.ShardMesh(P, 'cpu'),
                         spill_dir=str(tmp_path / 'x'))
  with pytest.raises(ValueError, match='hot_prefix_rows'):
    df.dist_scan_tables()
  with pytest.raises(ValueError, match='spill_dir'):
    TieredDistFeature(P, feats, node_pb, mesh=gdist.ShardMesh(P, 'cpu'))


def test_oversubscribed_device_arrays_is_refused(tmp_path):
  parts, feats, node_pb, _ = ring(P, TPart)
  mesh = gdist.ShardMesh(P, 'cpu')
  over = TieredDistFeature(P, feats, node_pb, mesh=mesh,
                           spill_dir=str(tmp_path / 'o'), hot_prefix_rows=2)
  with pytest.raises(RuntimeError) as ei:
    over.device_arrays()
  assert 'TieredDistScanTrainer' in str(ei.value)
  assert 'hot_prefix_rows=2' in str(ei.value)
  ids = np.asarray([0, 3, 5], np.int64)
  want = ids[:, None].astype(np.float32) * np.ones((1, 4), np.float32)
  np.testing.assert_array_equal(over.cpu_get(ids).numpy(), want)
  full = TieredDistFeature(P, feats, node_pb, mesh=mesh,
                           spill_dir=str(tmp_path / 'f'))
  assert full.device_arrays()['feats'].shape[0] == P


def test_demand_paged_get_bit_identical(tmp_path):
  parts, feats, node_pb, _ = ring(P, TPart)
  mesh = gdist.ShardMesh(P, 'cpu')
  over = TieredDistFeature(P, feats, node_pb, mesh=mesh,
                           spill_dir=str(tmp_path / 'o'),
                           hot_prefix_rows=HOT)
  full = TieredDistFeature(P, feats, node_pb, mesh=mesh,
                           spill_dir=str(tmp_path / 'f'))
  jfull = glt.distributed.DistFeature(P, feats, node_pb, jmesh(P))
  rng = np.random.default_rng(5)
  b, steps = 6, 4
  pages0 = counter('storage.demand_pages')
  paged0 = counter('storage.demand_paged_rows')
  miss0 = counter('storage.prefetch_miss')
  for step in range(steps):
    ids = rng.integers(0, N, (P, b)).astype(np.int64)
    ids[0, -1] = -1
    if step == steps - 1:     # every id in its owner's hot prefix
      ids = np.tile(np.arange(b) % (2 * HOT), (P, 1)).astype(np.int64)
    got = over.get(ids).numpy()
    np.testing.assert_array_equal(got, full.get(ids).numpy())
    np.testing.assert_array_equal(got, np.asarray(jfull.get(ids)))
  paged = counter('storage.demand_paged_rows') - paged0
  assert counter('storage.demand_pages') - pages0 == steps
  assert paged > 0 and counter('storage.prefetch_miss') - miss0 == paged
  assert over.stats() == full.stats()


def test_tiered_dist_feature_and_spill_equal_jax(tmp_path):
  from graphlearn_tpu.storage import TieredDistFeature as JTiered
  from graphlearn_tpu.storage import spill_partitions as jspill
  parts, feats, node_pb, _ = ring(P, TPart)
  tparts = spill_partitions(str(tmp_path / 't'), feats, rows_per_chunk=8)
  jparts = jspill(str(tmp_path / 'j'), feats, rows_per_chunk=8)
  for i, ((ti, _), (ji, _)) in enumerate(zip(tparts, jparts)):
    np.testing.assert_array_equal(ti, ji)
    jdir = tmp_path / 'j' / f'part_{i:03d}'
    tdir = tmp_path / 't' / f'part_{i:03d}'
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in sorted(os.listdir(jdir)):
      assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
  t = TieredDistFeature(P, tparts, node_pb, mesh=gdist.ShardMesh(P, 'cpu'),
                        cache_rows=6, hot_prefix_rows=HOT)
  j = JTiered(P, jparts, node_pb, mesh=jmesh(P), cache_rows=6,
              hot_prefix_rows=HOT)
  ids = np.asarray([-1, 0, 7, 39, 12, 5])
  np.testing.assert_array_equal(t.cpu_get(ids).numpy(), j.cpu_get(ids))
  assert t.tier_bytes() == j.tier_bytes()
  np.testing.assert_array_equal(t.cache_ids, j.cache_ids)
  np.testing.assert_array_equal(
      t.dist_scan_tables()['hot'].numpy(),
      np.asarray(j.dist_scan_tables()['hot']))
  with pytest.raises(ValueError, match='sorted-id order'):
    TieredDistFeature(P, [(ti[::-1].copy(), tt) for ti, tt in tparts],
                      node_pb, mesh=gdist.ShardMesh(P, 'cpu'))


@pytest.mark.parametrize('seed', [0, 1])
def test_plan_exchange_equals_jax(seed):
  rng = np.random.default_rng(seed)
  parts, feats, node_pb, _ = ring(P, TPart)
  df = gdist.DistFeature(P, feats, node_pb, gdist.ShardMesh(P, 'cpu'),
                         cache_rows=5)
  rows = rng.integers(-1, N, (P, 7, 9))
  for hot in (0, 3):
    got = planner.plan_exchange(rows, 3, node_pb, df.feat_ids, hot,
                                cache_ids=df.cache_ids)
    want = jplanner.plan_exchange(rows, 3, node_pb, df.feat_ids, hot,
                                  cache_ids=df.cache_ids)
    assert got.num_chunks == want.num_chunks == 3
    assert got.slab_caps() == want.slab_caps()
    assert got.stats() == want.stats()
    for a, b in zip(got.chunk_rows, want.chunk_rows):
      np.testing.assert_array_equal(a, b)


def test_dist_stager_slab_layout(tmp_path):
  parts, feats, node_pb, _ = ring(P, TPart)
  store = TieredDistFeature(P, feats, node_pb,
                            mesh=gdist.ShardMesh(P, 'cpu'),
                            spill_dir=str(tmp_path), hot_prefix_rows=HOT)
  n_max = store.n_max
  enc = [np.array([0 * n_max + 5, 0 * n_max + 9, 1 * n_max + 4]),
         np.zeros((0,), np.int64)]
  st = DistChunkStager(store, max_ahead=1)
  st.begin_epoch(enc)
  ids, rows = st.take(0)
  assert ids.shape == (P, 2) and rows.shape == (P, 2, 4)
  assert ids[0].tolist() == [5, 9] and ids[1].tolist() == [4, 2 ** 31 - 1]
  want = store.cpu_get(store.feat_ids[0, [5, 9]]).numpy()
  np.testing.assert_array_equal(rows[0].numpy(), want)
  st.ack(0)
  ids, rows = st.take(1)
  assert ids.shape == (P, 1) and (ids.numpy() == 2 ** 31 - 1).all()
  st.ack(1)
  st.close()
