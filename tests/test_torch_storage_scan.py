"""The port's ``TieredScanTrainer``, spilled serving stores and the papers
example's three-tier mode against the port's own all-device runs and
the JAX package's, on the CPU.

Ports ``tests/test_storage.py``'s trainer tests and the tiered parts of
``tests/test_recovery.py`` at JAX's size (N = 96, F = 6, ``[3, 2]`` at
batch 8, 44 seeds: 5 full batches and a ragged tail, K = 4: a full chunk
and a tail chunk):

- the epoch plan's ``chunk_rows`` from the port's fused prologue, from
  the port's ``plan_epoch_host`` and from JAX's, exactly equal, shuffle
  on and off;
- the tiered epoch's losses and parameters bit-identical to the port's
  ``ScanTrainer`` over two epochs, and within atol 1e-5 / rtol 1e-4 of
  JAX's ``TieredScanTrainer`` from converted parameters;
- a degraded epoch (a stalled and a raising worker) bit-identical to the
  healthy one, chunk-boundary overlap under a slow stub, the stage/ack
  hooks, and the pow2 slab-shape closure;
- a tiered epoch crashed at a chunk boundary and resumed under
  ``ChunkCheckpointer``, equal to the uninterrupted run, with the
  staging watermarks in the snapshot's meta;
- ``FusedEpochTrainer``'s refusal of a store with a host part, naming a
  trainer that exists;
- the spilled materializer: one tier per layer pass, the tiered and
  restarted stores equal to ``embedding_store()`` and within fp32
  tolerance of JAX's, ``update_rows`` refused;
- the papers example's ``--spill-dir`` mode at a tiny size: its losses
  track the JAX example's.
"""
import importlib.util
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu import metrics as jmetrics
from graphlearn_tpu import storage as jstorage
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch import metrics as tmetrics
from graphlearn_tpu_torch import storage as tstorage
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.recovery import ChunkCheckpointer

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, F, C = 96, 6, 3
SEEDS, K = 44, 4
HOT, WARM = 16, 30
TOL = dict(atol=1e-5, rtol=1e-4)
CPU = 'cpu'


def _graph(seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _pool(num=SEEDS):
  return np.random.default_rng(9).permutation(N)[:num].astype(np.int64)


def _loader(store_dir=None, num=SEEDS, hot=HOT, warm=WARM, **kw):
  """The port's loader; with ``store_dir`` over a TieredFeature spilled
  there, else over the all-device Feature."""
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(ei, num_nodes=N)
  if store_dir is None:
    ds.init_node_features(feats)
  else:
    ds.node_features = tstorage.TieredFeature(
        feats, hot_rows=hot, warm_rows=warm, spill_dir=str(store_dir),
        device=CPU)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', 8)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return gtt.loader.NeighborLoader(ds, [3, 2], _pool(num), device=CPU, **kw)


def _jax_loader(store_dir=None, **kw):
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  if store_dir is None:
    ds.init_node_features(feats)
  else:
    ds.node_features = jstorage.TieredFeature(
        feats, hot_rows=HOT, warm_rows=WARM, spill_dir=str(store_dir))
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', 8)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return glt.loader.NeighborLoader(ds, [3, 2], _pool(), **kw)


def _model(seed=0):
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device=CPU,
                              generator=torch.Generator().manual_seed(seed))


def _params(model):
  return [p.detach().clone() for p in model.parameters()]


def _assert_params_equal(a, b):
  for x, y in zip(a, b):
    assert torch.equal(x, y)


def _tiered(tmp_path, name='sp', model_seed=0, **kw):
  tkw = {k: kw.pop(k) for k in ('stage_timeout_s', 'max_ahead',
                                'chunk_size') if k in kw}
  tkw.setdefault('chunk_size', K)
  model = _model(model_seed)
  tr = tstorage.TieredScanTrainer(_loader(tmp_path / name, **kw), model, C,
                                  **tkw)
  return tr, ttrain.create_train_state(model)


@pytest.fixture(scope='module')
def hbm_run():
  """Two epochs of the port's all-device ScanTrainer per shuffle mode:
  the bit-identity reference."""
  out = {}
  for shuffle in (False, True):
    model = _model()
    tr = gtt.loader.ScanTrainer(_loader(shuffle=shuffle), model, C,
                                chunk_size=K)
    state = ttrain.create_train_state(model)
    state, losses, accs = tr.run_epoch(state)
    params = _params(model)
    state, losses2, _ = tr.run_epoch(state)
    out[shuffle] = dict(losses=losses, accs=accs, params=params,
                        losses2=losses2, params2=_params(model))
  return out


# ------------------------------------------------------------------ plan


def _jax_perm_key(epoch):
  return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                               0xFFFFFFFF), epoch)


@pytest.mark.parametrize('shuffle', [False, True])
def test_plan_matches_host_replays_and_jax(tmp_path, shuffle):
  """The fused prologue's plan == the port's host replay == JAX's host
  replay, chunk by chunk, exactly."""
  tr, state = _tiered(tmp_path, shuffle=shuffle)
  loader, store = tr.loader, tr._store
  host = tstorage.planner.plan_epoch_host(
      loader.sampler, loader.input_seeds,
      gtt.random.fold_in(tr._perm_key, 0), steps=6, batch=8,
      shuffle=shuffle, chunk_size=K, hot_rows=store.hot_rows,
      warm_rows=store.warm_rows)
  jl = _jax_loader(tmp_path / 'j', shuffle=shuffle)
  jplan = jstorage.planner.plan_epoch_host(
      jl.sampler, jl.input_seeds, _jax_perm_key(0), steps=6, batch=8,
      shuffle=shuffle, chunk_size=K, hot_rows=HOT, warm_rows=WARM)
  tr.run_epoch(state)
  got = tr.last_plan
  assert got.num_chunks == host.num_chunks == jplan.num_chunks == 2
  for a, b, c in zip(got.chunk_rows, host.chunk_rows, jplan.chunk_rows):
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
  assert got.stats() == jplan.stats()
  assert all(c == tstorage.pow2_slab_cap(c) for c in got.slab_caps())
  assert tr.prologue_ms > 0
  # the seed replay alone, against JAX's
  seeds = np.asarray(loader.input_seeds)
  for nparts, steps in ((1, 6), (2, 3)):
    a = tstorage.planner.replay_seed_matrix(
        seeds, gtt.random.fold_in(tr._perm_key, 1), steps, 8, shuffle,
        nparts=nparts)
    b = jstorage.planner.replay_seed_matrix(seeds, _jax_perm_key(1), steps,
                                            8, shuffle, nparts=nparts)
    for x, y in zip(a, b):
      np.testing.assert_array_equal(x, y)
  tr.close()


# ----------------------------------------------------------------- epoch


@pytest.mark.parametrize('shuffle', [False, True])
def test_tiered_epoch_bit_identical_to_scan_trainer(tmp_path, hbm_run,
                                                    shuffle):
  """The tiered epoch over a store ~6x beyond its hot tier: losses,
  accuracies and parameters bit-identical to the all-device ScanTrainer
  (a ragged tail and a tail chunk), and a second epoch continues both
  streams identically; every planned row was staged by the worker."""
  want = hbm_run[shuffle]
  staged0 = tmetrics.default_registry().counters().get(
      'storage.staged_rows', 0)
  tr, state = _tiered(tmp_path, shuffle=shuffle)
  state, losses, accs = tr.run_epoch(state)
  assert torch.equal(losses, want['losses'])
  assert torch.equal(accs, want['accs'])
  _assert_params_equal(_params(tr.model), want['params'])
  assert not tr._stager.degraded
  assert tmetrics.default_registry().counters()['storage.staged_rows'] - \
      staged0 == tr.last_plan.stats()['planned_rows'] > 0
  state, losses2, _ = tr.run_epoch(state)
  assert torch.equal(losses2, want['losses2'])
  _assert_params_equal(_params(tr.model), want['params2'])
  assert state.step == 12 and tr._sampler._call_count == 12
  timings = tr.chunk_timings()
  assert [t['chunk'] for t in timings] == [0, 1]
  assert sum(t['rows'] for t in timings) == \
      tr.last_plan.stats()['planned_rows']
  assert all(t['stage_ms'] is not None and t['wait_ms'] >= 0
             for t in timings)
  tr.close()


def test_tiered_epoch_tracks_jax(tmp_path):
  """The port's tiered epoch from JAX's converted parameters: the same
  plan, and losses, accuracies and parameters within atol 1e-5 / rtol
  1e-4 of JAX's TieredScanTrainer over two epochs."""
  jl = _jax_loader(tmp_path / 'j')
  jmodel = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(_jax_loader())))
  jstate, tx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0),
                                         first)
  jtr = jstorage.TieredScanTrainer(jl, jmodel, tx, C, chunk_size=K)
  model = _model()
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  tr = tstorage.TieredScanTrainer(_loader(tmp_path / 't'), model, C,
                                  chunk_size=K)
  state = ttrain.create_train_state(model)
  for _ in range(2):
    jstate, jlosses, jaccs = jtr.run_epoch(jstate)
    state, losses, accs = tr.run_epoch(state)
    for a, b in zip(tr.last_plan.chunk_rows, jtr.last_plan.chunk_rows):
      np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)
  jtr.close()
  tr.close()


@pytest.mark.parametrize('fault', ['raise', 'stall'])
def test_degraded_epoch_bit_identical(tmp_path, hbm_run, fault):
  """A raising worker, or one slower than the take timeout: the epoch
  degrades to synchronous reads of the same planned rows and completes
  bit-identically, with prefetch_miss counting them."""
  tr, state = _tiered(tmp_path, stage_timeout_s=5.0 if fault == 'raise'
                      else 0.05)

  def boom():
    if fault == 'raise':
      raise RuntimeError('injected staging fault')
    time.sleep(0.3)

  tr._stager._stage_fault = boom
  miss0 = tmetrics.default_registry().counters().get(
      'storage.prefetch_miss', 0)
  state, losses, _ = tr.run_epoch(state)
  assert tr._stager.degraded
  assert tmetrics.default_registry().counters()['storage.prefetch_miss'] - \
      miss0 == tr.last_plan.stats()['planned_rows']
  assert torch.equal(losses, hbm_run[False]['losses'])
  _assert_params_equal(_params(tr.model), hbm_run[False]['params'])
  tr.close()


def test_chunk_boundary_overlap(tmp_path):
  """With a slow device stub (each chunk sleeps 0.25 s), chunk c+1's slab
  is staged before chunk c is acked: the double buffer overlaps."""
  tr, state = _tiered(tmp_path, num=40, hot=8, warm=8, chunk_size=1)
  real = tr._chunk

  def slow_chunk(*args, **kw):
    out = real(*args, **kw)
    time.sleep(0.25)
    return out

  tr._chunk = slow_chunk
  tr.run_epoch(state)
  st, ack = tr._stager.stage_done_t, tr._stager.ack_t
  assert not tr._stager.degraded
  for c in range(0, 3):
    assert st[c + 1] < ack[c], (c, st, ack)
  tr.close()


def test_stage_ack_hooks_and_pow2_shape_closure(tmp_path):
  """stage_hook fires before each chunk, ack_hook after, in chunk order;
  a second (unshuffled) epoch presents the same pow2 slab caps, so the
  static slab is not reallocated."""
  tr, state = _tiered(tmp_path)
  events = []
  tr.stage_hook = lambda c, start, k: events.append(('stage', c, k))
  tr.ack_hook = lambda c, start, k: events.append(('ack', c, k))
  state, _, _ = tr.run_epoch(state)
  assert events == [('stage', 0, 4), ('ack', 0, 4),
                    ('stage', 1, 2), ('ack', 1, 2)]
  caps, slab = tr.last_plan.slab_caps(), tr._slab_ids
  assert all(c == tstorage.pow2_slab_cap(c) for c in caps)
  assert slab.shape[0] == max(caps)
  assert tr.slab_bytes == max(caps) * (4 + F * 4)
  tr.run_epoch(state)
  assert tr.last_plan.slab_caps() == caps and tr._slab_ids is slab
  tr.close()


# -------------------------------------------------------------- recovery


def test_tiered_crash_resume_equals_the_uninterrupted_epoch(tmp_path):
  """A tiered epoch (shuffle=True) killed at chunk 1 resumes from the
  boundary snapshot in a fresh trainer: the resume plans again and
  stages from the resume chunk; losses and parameters equal the
  uninterrupted run's, and the snapshot carries the ring's watermarks."""
  ref, state = _tiered(tmp_path, 'ref', shuffle=True, chunk_size=2)
  state, want, _ = ref.run_epoch(state)
  want_params = _params(ref.model)
  ref.close()
  ckdir = str(tmp_path / 'ck')
  victim, vstate = _tiered(tmp_path, 'v', shuffle=True, chunk_size=2)
  ck = ChunkCheckpointer(ckdir, every=1).attach(victim)

  def killer(c, start, k):
    if c == 2:
      raise RuntimeError('injected mid-epoch crash')

  victim.stage_hook = killer
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(vstate)
  ck.close()
  victim.close()
  snap = ChunkCheckpointer(ckdir).latest()
  assert snap.meta['staging']['next_submit'] >= 2
  assert snap.meta['staging']['planned'] == 3
  fresh, template = _tiered(tmp_path, 'f', model_seed=5, shuffle=True,
                            chunk_size=2)
  state, losses, _ = ChunkCheckpointer(ckdir).resume_epoch(fresh, template)
  np.testing.assert_array_equal(losses, want.numpy())
  _assert_params_equal(_params(fresh.model), want_params)
  assert fresh._stager.watermarks()['next_submit'] == 3
  fresh.close()


def test_fused_trainers_refuse_a_host_part_naming_the_tiered_trainer(
    tmp_path):
  loader = _loader(tmp_path / 'sp')
  with pytest.raises(ValueError, match='storage.TieredScanTrainer') as exc:
    gtt.loader.ScanTrainer(loader, _model(), C, chunk_size=K)
  name = str(exc.value).split('storage.')[1].split(')')[0]
  assert getattr(gtt.storage, name) is tstorage.TieredScanTrainer
  with pytest.raises(ValueError, match='TieredFeature'):
    tstorage.TieredScanTrainer(_loader(), _model(), C)


# --------------------------------------------------------------- serving


def test_materializer_spill_tiered_and_restarted_stores(tmp_path):
  """Each layer pass spills to a disk tier; the tiered store and the
  restarted (warm) stores serve the rows of embedding_store() exactly and
  within fp32 tolerance of JAX's; the tiered store is immutable."""
  from graphlearn_tpu.serving import warm_embedding_store as jwarm
  from graphlearn_tpu.serving.materialize import EmbeddingMaterializer as JM
  n = 64
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(n), 4)
  cols = (rows + rng.integers(1, n, rows.shape[0])) % n
  feat = rng.standard_normal((n, F)).astype(np.float32)
  jds = glt.data.Dataset()
  jds.init_graph(np.stack([rows, cols]), graph_mode='CPU', num_nodes=n)
  jds.init_node_features(feat)
  jmodel = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  params = jmodel.init(jax.random.PRNGKey(0), np.zeros((4, F), np.float32),
                       np.zeros((2, 4), np.int32), np.ones(4, bool))
  jmat = JM(jds, jmodel, params, block_size=16, chunk_size=2,
            spill_dir=str(tmp_path / 'j'))
  jmat.materialize()
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(np.stack([rows, cols]), num_nodes=n)
  ds.init_node_features(feat)
  model = _model()
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  mat = gtt.serving.EmbeddingMaterializer(ds, model, block_size=16,
                                          chunk_size=2,
                                          spill_dir=str(tmp_path / 't'))
  mat.materialize()
  assert sorted(mat.spilled) == sorted(jmat.spilled) == ['0', '1']
  base = mat.embedding_store()
  tiered = mat.tiered_embedding_store(hot_rows=8, warm_rows=16)
  assert isinstance(tiered, gtt.serving.TieredEmbeddingStore)
  ids = np.array([0, 5, 63, 33, -1, -1, 12, 40])
  mask = ids >= 0
  expect = base.fetch(base.lookup(np.maximum(ids, 0), mask))
  np.testing.assert_array_equal(tiered.fetch(tiered.lookup(ids, mask)),
                                expect)
  jtiered = jmat.tiered_embedding_store(hot_rows=8, warm_rows=16)
  np.testing.assert_allclose(expect, jtiered.fetch(jtiered.lookup(ids, mask)),
                             rtol=1e-5, atol=1e-6)
  with pytest.raises(NotImplementedError):
    tiered.update_rows(np.array([1]), np.zeros((1, C), np.float32))
  # restart from the spill, without rematerializing
  real = ids[mask]
  expect = base.fetch(base.lookup(real, np.ones(real.shape, bool)))
  ones = np.ones(real.shape, bool)
  for kw in (dict(), dict(hot_rows=8, warm_rows=16)):
    warm = gtt.serving.warm_embedding_store(str(tmp_path / 't'),
                                            num_nodes=n, device=CPU, **kw)
    assert warm.num_nodes == n
    np.testing.assert_array_equal(warm.fetch(warm.lookup(real, ones)),
                                  expect)
    jw = jwarm(str(tmp_path / 'j'), num_nodes=n, **kw)
    np.testing.assert_allclose(expect, jw.fetch(jw.lookup(real, ones)),
                               rtol=1e-5, atol=1e-6)
  # the JAX package's spill restarts in the port, and the port's in JAX
  cross = gtt.serving.warm_embedding_store(str(tmp_path / 'j'), num_nodes=n,
                                           hot_rows=8, device=CPU)
  np.testing.assert_allclose(cross.fetch(cross.lookup(real, ones)), expect,
                             rtol=1e-5, atol=1e-6)
  with pytest.raises(FileNotFoundError):
    gtt.serving.warm_embedding_store(str(tmp_path / 'nothing'), num_nodes=4,
                                     device=CPU)
  with pytest.raises(ValueError, match='exceeds'):
    gtt.serving.warm_embedding_store(str(tmp_path / 't'), num_nodes=10 ** 6,
                                     device=CPU)
  no_spill = gtt.serving.EmbeddingMaterializer(ds, model, block_size=16)
  no_spill.materialize()
  with pytest.raises(ValueError, match='spill_dir'):
    no_spill.tiered_embedding_store()


# --------------------------------------------------------------- example


def _jax_tiered_example(monkeypatch, argv):
  """The JAX example's three-tier mode as it is, its initial parameters
  and the epoch's losses recorded."""
  spec = importlib.util.spec_from_file_location(
      'jax_train_sage_papers_scale',
      ROOT / 'examples' / 'train_sage_papers_scale.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  rec = {}
  create = jtrain.create_train_state
  run_epoch = jstorage.TieredScanTrainer.run_epoch

  def create_and_record(*a, **kw):
    state, tx = create(*a, **kw)
    rec['params0'] = jax.tree.map(np.asarray, state.params)
    return state, tx

  def run_and_record(self, *a, **kw):
    out = run_epoch(self, *a, **kw)
    rec['losses'] = np.asarray(out[1])
    return out

  monkeypatch.setattr(jtrain, 'create_train_state', create_and_record)
  monkeypatch.setattr(jstorage.TieredScanTrainer, 'run_epoch',
                      run_and_record)
  monkeypatch.setattr(glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  monkeypatch.setattr(sys, 'argv', ['train_sage_papers_scale.py'] + argv)
  # the example prints the process's counter totals: keep the base
  rec['counters0'] = jmetrics.default_registry().counters('storage.')
  mod.main()
  return rec


def test_papers_scale_spill_dir_tracks_the_jax_example(tmp_path,
                                                       monkeypatch, capsys):
  from graphlearn_tpu_torch.examples import train_sage_papers_scale as papers
  argv = ['--num-nodes', '6000', '--feat-dim', '16', '--hot-gb', '0.00015',
          '--warm-gb', '0.0001', '--steps', '6', '--batch-size', '8',
          '--chunk-size', '4']
  rec = _jax_tiered_example(monkeypatch,
                            argv + ['--spill-dir', str(tmp_path / 'j')])
  jline = capsys.readouterr().out.strip().splitlines()[-1]
  args = papers.parser().parse_args(
      argv + ['--spill-dir', str(tmp_path / 't'), '--device', CPU])
  result, losses = papers.run(args, rec['params0'])
  import json
  jres = json.loads(jline)
  for key in ('tiers', 'staged_rows', 'prefetch_miss', 'prefetch_hit_rate',
              'plan', 'epoch_wall_s', 'steps', 'num_nodes', 'feat_gb'):
    assert key in result, key
  assert result['tiers'] == jres['tiers']
  assert result['plan'] == jres['plan']
  for key in ('staged_rows', 'prefetch_miss'):
    assert result[key] == jres[key] - rec['counters0'].get(
        f'storage.{key}', 0), key
  assert result['steps'] == jres['steps'] == 6
  assert len(losses) == len(rec['losses']) == 6
  np.testing.assert_allclose(losses, rec['losses'], rtol=1e-4, atol=0)
