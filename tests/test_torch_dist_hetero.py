"""The port's typed distributed engine, loaders and trainers against the
JAX package's on the CPU.

Fixture: ``tests/test_distributed.py``'s two-type ring (('u','to','v')
u_i -> v_i, v_{i+1}; ('v','back','u') v_i -> u_{i+2}; u_i on i % P, v_i
on (i + 1) % P; features ``u: id``, ``v: 1000 + id``; labels id % 3) at P
= 2 and 4, and ``tests/test_capacity_plans.py``'s typed tiered set-up.
JAX runs its shard_map programs on the conftest's CPU mesh, the port a
one-process ``ShardMesh``. Held exactly: typed ``sample_from_nodes``
(tree and merge, edge ids, weights, a node budget, the fractional
exchange, calibrated dict caps with the mesh-summed overflow verdict),
the typed chunk keys (``ops.dist_step_keys`` with hops x |edge types|
keys a shard), the typed loader's ``HeteroData`` (features, labels,
``seed_labels_only``), a typed partition directory loaded by both
packages and the typed ``feature_spill_dir`` store; the port's typed
scanned epoch against its per-step loop with per-type counters, the
typed tiered epoch against the all-device one (losses and parameters),
and a typed crash resumed from its chunk snapshot. Within atol 1e-5 /
rtol 1e-4: the typed ``DistScanTrainer``'s losses and parameters against
JAX's over two epochs.
"""
import copy
import os

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.typing import GraphPartitionData as JPart
from graphlearn_tpu.typing import reverse_edge_type
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch import random as trandom
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart

from test_torch_dist_link import hetero_graphs, hetero_ring
from test_torch_distributed import N, _np, jmesh, tmesh
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ET1, ET2 = ('u', 'to', 'v'), ('v', 'back', 'u')
FAN = {ET1: [2, 2], ET2: [1, 1]}
TOL = dict(atol=1e-5, rtol=1e-4)
FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask',
          'num_sampled_nodes', 'num_sampled_edges')
STATS = ('hits', 'misses', 'unique_misses', 'overflow', 'lookups')


def _eq(a, b, what):
  a, b = np.asarray(a), _np(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  np.testing.assert_array_equal(a, b, err_msg=what)


def assert_typed_equal(jo, to, fields, what):
  for f in fields:
    a, b = getattr(jo, f), getattr(to, f)
    assert set(a) == set(b), (what, f, sorted(a), sorted(b))
    for k in a:
      _eq(a[k], b[k], f'{what} {f} {k}')


def typed_feats(pb, num_parts, v_base=1000.0):
  """``u``: id, ``v``: ``v_base + id`` (the trainers take JAX's scan
  fixture, ``v_base = 0``)."""
  return {t: [(np.nonzero(pb[t] == p)[0],
               (v_base * (t == 'v') + np.nonzero(pb[t] == p)[0][:, None]
                ).astype(np.float32) * np.ones((1, 4), np.float32))
              for p in range(num_parts)] for t in ('u', 'v')}


def weighted_graphs(num_parts):
  raw, pb, _ = hetero_ring(num_parts)
  rng = np.random.default_rng(0)
  jparts, tparts = [], []
  for r in raw:
    jd, td = {}, {}
    for et, (e, i) in r.items():
      w = (rng.integers(1, 9, e.shape[1]) / 4).astype(np.float32)
      jd[et] = JPart(edge_index=e, eids=i, weights=w)
      td[et] = TPart(edge_index=e, eids=i, weights=w)
    jparts.append(jd)
    tparts.append(td)
  return (glt.distributed.DistHeteroGraph(num_parts, 0, jparts, pb),
          gdist.DistHeteroGraph(num_parts, 0, tparts, pb))


# ---------------------------------------------------------------- sampler

SAMPLER_CASES = [
    (2, dict()), (4, dict(dedup='tree', with_edge=True)),
    (2, dict(bucket_frac=None, with_edge=True)),
    (4, dict(bucket_frac=0.25)),
    (2, dict(dedup='tree', node_budget=3)),
    (2, dict(with_weight=True)),
]


@pytest.mark.parametrize('p,kw', SAMPLER_CASES)
def test_typed_sample_from_nodes_equals_jax(p, kw):
  if kw.get('with_weight'):
    jg, tg = weighted_graphs(p)
  else:
    raw, pb, _ = hetero_ring(p)
    jg, tg = hetero_graphs(raw, pb)
  js = glt.distributed.DistNeighborSampler(jg, FAN, jmesh(p), seed=3, **kw)
  ts = gdist.DistNeighborSampler(tg, FAN, tmesh(p), seed=3, **kw)
  assert ts._hetero_plan({'u': 3}) == js._hetero_plan({'u': 3})
  gdist.reset_verdict_syncs()
  for it in range(2):
    seeds = ((np.arange(3 * p) * 7 + it) % N).astype(np.int32).reshape(p, 3)
    mask = np.ones_like(seeds, bool)
    mask[-1, -1] = it == 0
    jo = js.sample_from_nodes(('u', seeds), seed_mask=mask)
    to = ts.sample_from_nodes(('u', seeds), seed_mask=mask)
    assert to.input_type == 'u'
    assert_typed_equal(jo, to, FIELDS + (('edge',) if kw.get('with_edge')
                                         else ()), f'{p} {it}')
    for k in ('seed_inverse', 'overflow', 'seed_mask'):
      _eq(jo.metadata[k], to.metadata[k], k)
  assert ts.state_dict() == js.state_dict()
  if kw.get('bucket_frac', 2.0) is None:
    assert gdist.verdict_syncs() == 0


@pytest.mark.parametrize('caps,stride,overflows', [
    ({ET1: [6, 12], ET2: [3, 6]}, 1, False),
    ({ET1: [4, 2], ET2: [2, 1]}, 13, True)])
def test_typed_calibrated_caps_and_verdict_equal_jax(caps, stride,
                                                     overflows):
  raw, pb, _ = hetero_ring(2)
  jg, tg = hetero_graphs(raw, pb)
  js = glt.distributed.DistNeighborSampler(jg, FAN, jmesh(2), seed=1,
                                           dedup='merge', frontier_caps=caps)
  ts = gdist.DistNeighborSampler(tg, FAN, tmesh(2), seed=1, dedup='merge',
                                 frontier_caps=caps)
  assert ts.frontier_caps == js.frontier_caps and ts.clamped_exact
  assert ts._hetero_plan({'u': 4}) == js._hetero_plan({'u': 4})
  seeds = ((np.arange(8) * stride) % N).astype(np.int32).reshape(2, 4)
  jo = js.sample_from_nodes(('u', seeds))
  to = ts.sample_from_nodes(('u', seeds))
  assert_typed_equal(jo, to, FIELDS, 'caps')
  _eq(jo.metadata['overflow'], to.metadata['overflow'], 'overflow')
  assert bool(_np(to.metadata['overflow']).all()) == overflows
  assert bool(_np(to.metadata['overflow']).any()) == overflows


def test_typed_refusals_in_jax_words():
  raw, pb, _ = hetero_ring(2)
  _, tg = hetero_graphs(raw, pb)
  with pytest.raises(ValueError, match='list-form frontier_caps'):
    gdist.DistNeighborSampler(tg, FAN, tmesh(2), frontier_caps=[4, 4])
  with pytest.raises(ValueError, match='not in'):
    gdist.DistNeighborSampler(tg, FAN, tmesh(2),
                              frontier_caps={('a', 'b', 'c'): [1]})
  ts = gdist.DistNeighborSampler(tg, FAN, tmesh(2))
  with pytest.raises(ValueError, match='unknown input node type'):
    ts.sample_from_nodes(('w', np.zeros((2, 2), np.int32)))
  with pytest.raises(AssertionError, match='input node type'):
    ts.sample_from_nodes(np.zeros((2, 2), np.int32))


def test_typed_chunk_keys_are_the_engines_keys():
  """A typed shard key splits into hops x |edge types| keys (JAX's
  ``_hetero_engine``); ``ops.dist_step_keys`` with that count gives
  JAX's words, and the engine's item j takes key j."""
  import jax
  raw, pb, _ = hetero_ring(2)
  _, tg = hetero_graphs(raw, pb)
  ts = gdist.DistNeighborSampler(tg, FAN, tmesh(2), seed=5)
  n = ts._hetero_key_count()
  assert n == 4
  base = jax.random.PRNGKey(5)
  got = ops.dist_step_keys(trandom.PRNGKey(5), torch.tensor(3), 2, 2, n)
  for j in range(2):
    shard = jax.random.split(jax.random.fold_in(base, 3 + j), 2)
    for q in range(2):
      _eq(np.asarray(jax.random.split(shard[q], n)).astype(np.int64),
          got[j, q], f'{j} {q}')
  items = sum(len(h) for h in ts._hetero_plan({'u': 2})[1])
  assert items <= n


# ----------------------------------------------------------------- loader

def typed_datasets(p, labels=True, jf_kw=None, tf_kw=None, v_base=1000.0):
  raw, pb, _ = hetero_ring(p)
  jg, tg = hetero_graphs(raw, pb)
  feats = typed_feats(pb, p, v_base)
  lab = {'u': np.arange(N) % 3, 'v': np.arange(N) % 3} if labels else None
  jf = {t: glt.distributed.DistFeature(p, feats[t], pb[t], jmesh(p),
                                       **(jf_kw or {})) for t in feats}
  tf = {t: gdist.DistFeature(p, feats[t], pb[t], tmesh(p), **(tf_kw or {}))
        for t in feats}
  return (glt.distributed.DistDataset(p, 0, jg, jf, node_labels=lab),
          gdist.DistDataset(p, 0, tg, tf, node_labels=lab))


@pytest.mark.parametrize('kw', [
    dict(batch_size=4, shuffle=True, seed=0),
    dict(batch_size=3, seed=1, drop_last=False, dedup='tree',
         seed_labels_only=True)])
def test_typed_loader_equals_jax(kw):
  jds, tds = typed_datasets(2, jf_kw=dict(split_ratio=0.25),
                            tf_kw=dict(split_ratio=0.25))
  jl = glt.distributed.DistNeighborLoader(jds, FAN, ('u', np.arange(N)),
                                          mesh=jmesh(2), **kw)
  tl = gdist.DistNeighborLoader(tds, FAN, ('u', np.arange(N)),
                                mesh=tmesh(2), **kw)
  assert tl.input_type == 'u' and len(tl) == len(jl) > 0
  with published(tds.node_features) as stats:
    for jb, tb in zip(jl, tl):
      assert isinstance(tb, gtt.loader.HeteroData)
      assert_typed_equal(jb, tb, ('node', 'num_nodes', 'edge_index',
                                  'edge_mask', 'x', 'y', 'batch',
                                  'num_sampled_nodes', 'num_sampled_edges'),
                         'loader')
      for t, base in (('u', 0.0), ('v', 1000.0)):
        valid = tb.node[t] >= 0
        assert torch.equal(tb.x[t][..., 0][valid],
                           base + tb.node[t][valid].float())
  # the epoch published each store's counters once, at its end
  assert all(s['lookups'] > 0 for s in stats.values())
  assert all(f.stats()['lookups'] == 0 for f in tds.node_features.values())


def test_typed_partition_dir_and_spill_load_equal_jax(tmp_path):
  """A typed partition directory written by the port's
  ``RandomPartitioner``, loaded by both packages; the batches of the
  port's loader equal JAX's, and ``feature_spill_dir`` builds one
  ``TieredDistFeature`` per node type serving the same rows."""
  rng = np.random.default_rng(7)
  nu, nv = 30, 20
  ei = {ET1: np.stack([rng.integers(0, nu, 90), rng.integers(0, nv, 90)]),
        ET2: np.stack([rng.integers(0, nv, 60), rng.integers(0, nu, 60)])}
  feat = {'u': rng.standard_normal((nu, 4)).astype(np.float32),
          'v': rng.standard_normal((nv, 4)).astype(np.float32)}
  gtt.partition.RandomPartitioner(
      str(tmp_path / 'parts'), 2, {'u': nu, 'v': nv}, ei, node_feat=feat,
      seed=0).partition()
  labels = {'u': np.arange(nu) % 3, 'v': np.arange(nv) % 3}
  root = str(tmp_path / 'parts')
  jds = glt.distributed.DistDataset().load(root, mesh=jmesh(2),
                                           node_labels=labels,
                                           split_ratio=0.2)
  tds = gdist.DistDataset().load(root, mesh=tmesh(2), node_labels=labels,
                                 split_ratio=0.2)
  assert tds.graph.is_hetero and tds.graph.etypes == jds.graph.etypes
  for t in ('u', 'v'):
    _eq(jds.node_pb[t], tds.node_pb[t], t)
    _eq(jds.node_feat_pb[t], tds.node_feat_pb[t], t)
    assert tds.node_features[t].cache_rows == \
        jds.node_features[t].cache_rows
  assert len(list(tds.feature_stores())) == 2
  fan = {ET1: [2], ET2: [2]}
  jl = glt.distributed.DistNeighborLoader(jds, fan, ('u', np.arange(nu)),
                                          batch_size=4, seed=0,
                                          mesh=jmesh(2))
  tl = gdist.DistNeighborLoader(tds, fan, ('u', np.arange(nu)),
                                batch_size=4, seed=0, mesh=tmesh(2))
  for jb, tb in zip(jl, tl):
    assert_typed_equal(jb, tb, ('node', 'edge_index', 'edge_mask', 'x',
                                'y'), 'dir')
  spill = str(tmp_path / 'spill')
  sds = gdist.DistDataset().load(root, mesh=tmesh(2), node_labels=labels,
                                 feature_spill_dir=spill)
  for t in ('u', 'v'):
    store = sds.node_features[t]
    assert isinstance(store, gtt.storage.TieredDistFeature)
    assert os.path.isdir(os.path.join(spill, f'node_{t}'))
    ids = torch.as_tensor(np.arange(16, dtype=np.int32).reshape(2, 8) % 20)
    plain = gdist.DistDataset().load(root, mesh=tmesh(2))
    assert torch.equal(store.get(ids), plain.node_features[t].get(ids))


# --------------------------------------------------------------- trainers

SEEDS = np.arange(14)          # global batch 4: 3 full steps + a ragged one


def jax_typed_loader(p=2, **kw):
  jds, _ = typed_datasets(p, jf_kw=dict(split_ratio=0.25), v_base=0.0)
  kw.setdefault('shuffle', False)
  return glt.distributed.DistNeighborLoader(
      jds, FAN, ('u', SEEDS), batch_size=2, drop_last=False, seed=0,
      mesh=jmesh(p), **kw)


def port_typed_loader(p=2, tf_kw=None, **kw):
  _, tds = typed_datasets(p, tf_kw=dict(split_ratio=0.25, **(tf_kw or {})),
                          v_base=0.0)
  kw.setdefault('shuffle', False)
  return gdist.DistNeighborLoader(
      tds, FAN, ('u', SEEDS), batch_size=2, drop_last=False, seed=0,
      mesh=tmesh(p), **kw)


MSG = (reverse_edge_type(ET1), reverse_edge_type(ET2))


def port_rgnn(params=None):
  model = gtt.models.RGNN(MSG, {'u': 4, 'v': 4}, 8, 3, num_layers=2,
                          out_ntype='u', device='cpu',
                          generator=torch.Generator().manual_seed(0))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model),
                          strict=False)
  return model


@pytest.fixture(scope='module')
def jax_typed_ref():
  """Two shuffled epochs of JAX's typed DistScanTrainer (one chunk of 4
  steps an epoch) and its published per-type feature counters."""
  import gc

  import jax
  import jax.numpy as jnp
  import optax
  from graphlearn_tpu.models import train as jtrain
  model = glt.models.RGNN(etypes=MSG, hidden_dim=8, out_dim=3,
                          num_layers=2, out_ntype='u')
  tx = optax.adam(1e-2)
  trainer = glt.loader.DistScanTrainer(jax_typed_loader(shuffle=True),
                                       model, tx, 3, chunk_size=4)
  first = next(iter(jax_typed_loader()))
  one = lambda d: {k: np.asarray(v)[0] for k, v in d.items()}
  params = model.init(jax.random.PRNGKey(0), one(first.x),
                      one(first.edge_index), one(first.edge_mask))
  state = jtrain.TrainState(params, tx.init(params), jnp.int32(0))
  out = dict(params0=jax.device_get(params))
  gc.collect()
  glt.utils.trace.reset_counters('dist_feature')
  for e in (1, 2):
    state, losses, accs = trainer.run_epoch(state)
    out[f'losses{e}'] = np.asarray(losses)
    out[f'accs{e}'] = np.asarray(accs)
    out[f'params{e}'] = jax.device_get(state.params)
    out[f'stats{e}'] = glt.utils.trace.counters('dist_feature')
    glt.utils.trace.reset_counters('dist_feature')
  return out


def assert_params_close(model, jparams):
  want = convert.params_from_flax(jparams, model)
  for name, p in model.named_parameters():
    np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                               err_msg=name, **TOL)


def test_typed_scanned_epochs_equal_jax(jax_typed_ref):
  model = port_rgnn(jax_typed_ref['params0'])
  loader = port_typed_loader(shuffle=True)
  trainer = gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=4)
  assert trainer._feat_types == ['u', 'v'] and trainer._n_hops == 4
  state = gtt.models.create_train_state(model, lr=1e-2)
  stores = loader.sampler.dist_feature
  for e in (1, 2):
    with published(stores) as got:
      state, losses, accs = trainer.run_epoch(state)
    assert losses.shape == (4,) and state.step == 4 * e
    np.testing.assert_allclose(losses.numpy(), jax_typed_ref[f'losses{e}'],
                               **TOL)
    np.testing.assert_allclose(accs.numpy(), jax_typed_ref[f'accs{e}'],
                               **TOL)
    assert_params_close(model, jax_typed_ref[f'params{e}'])
    # JAX publishes the sum over its stores under one prefix
    tot = {k: sum(s[k] for s in got.values()) for k in STATS}
    want = {k: jax_typed_ref[f'stats{e}'].get(f'dist_feature.{k}', 0)
            for k in STATS}
    assert tot == want
  assert loader.sampler._call_count == 8


@pytest.mark.parametrize('dedup,chunk,frac', [('merge', 3, 2.0),
                                              ('tree', 2, None)])
def test_typed_scanned_epoch_equals_the_per_step_loop(dedup, chunk, frac):
  model_a = port_rgnn()
  model_b = copy.deepcopy(model_a)
  fkw = dict(bucket_frac=frac)
  la = port_typed_loader(tf_kw=fkw, dedup=dedup, bucket_frac=frac)
  lb = port_typed_loader(tf_kw=fkw, dedup=dedup, bucket_frac=frac)
  ref = gtt.loader.DistFusedEpochTrainer(la, model_a, 3)
  trainer = gtt.loader.DistScanTrainer(lb, model_b, 3, chunk_size=chunk)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  for _ in range(2):
    gdist.reset_verdict_syncs()
    with published(la.sampler.dist_feature) as stats_a:
      sa, losses_a = ref.run_epoch_steps(sa)
    syncs = gdist.verdict_syncs()
    gdist.reset_verdict_syncs()
    with published(lb.sampler.dist_feature) as stats_b:
      sb, losses_b, _ = trainer.run_epoch(sb)
    assert gdist.verdict_syncs() == syncs
    assert torch.equal(torch.stack(losses_a), losses_b)
    for x, y in zip(model_a.parameters(), model_b.parameters()):
      assert torch.equal(x, y)
    # each epoch published each store's counters once, at its end
    assert stats_a == stats_b and sorted(stats_a) == ['u', 'v']
    assert all(s['lookups'] > 0 for s in stats_a.values())
  if frac is None:
    assert syncs == 0


def test_typed_capture_refusal_names_the_store():
  model = port_rgnn()
  with pytest.raises(ValueError, match="feature store 'u'.*bucket_frac=None"):
    gtt.loader.DistScanTrainer(port_typed_loader(bucket_frac=None), model,
                               3, capture=True)


def _tiered_loader(spill_dir=None, hot=4):
  raw, pb, _ = hetero_ring(2)
  _, tg = hetero_graphs(raw, pb)
  feats = typed_feats(pb, 2, 0.0)
  mesh = tmesh(2)
  if spill_dir is None:
    df = {t: gdist.DistFeature(2, feats[t], pb[t], mesh, split_ratio=0.25)
          for t in feats}
  else:
    df = {t: gtt.storage.TieredDistFeature(
        2, feats[t], pb[t], mesh=mesh, spill_dir=os.path.join(spill_dir, t),
        hot_prefix_rows=hot, split_ratio=0.25) for t in feats}
  ds = gdist.DistDataset(2, 0, tg, df,
                         node_labels={'u': np.arange(N) % 3,
                                      'v': np.arange(N) % 3})
  return gdist.DistNeighborLoader(ds, FAN, ('u', SEEDS), batch_size=2,
                                  shuffle=False, drop_last=False, seed=0,
                                  mesh=mesh)


def test_typed_tiered_epoch_bit_identical_to_all_device(tmp_path):
  model_a = port_rgnn()
  model_b = copy.deepcopy(model_a)
  ref = gtt.loader.DistScanTrainer(_tiered_loader(), model_a, 3,
                                   chunk_size=2)
  trainer = gtt.storage.TieredDistScanTrainer(
      _tiered_loader(str(tmp_path)), model_b, 3, chunk_size=2)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  for _ in range(2):
    sa, la, _ = ref.run_epoch(sa)
    sb, lb, _ = trainer.run_epoch(sb)
    assert torch.equal(la, lb)
    for x, y in zip(model_a.parameters(), model_b.parameters()):
      assert torch.equal(x, y)
  assert isinstance(trainer.last_plan, dict) and \
      set(trainer.last_plan) == {'u', 'v'}
  for t, plan in trainer.last_plan.items():
    assert plan.stats()['planned_rows'] > 0, t
  timings = trainer.chunk_timings()
  assert {r['ntype'] for r in timings} == {'u', 'v'}
  assert trainer.slab_bytes > 0
  with pytest.raises(gtt.sampler.CapacityPlanError, match="ntype 'u'"):
    gtt.storage.TieredDistScanTrainer(
        _tiered_loader(str(tmp_path / 'b'), hot=0), model_b, 3)
  trainer.close()


def test_typed_crash_resumes_with_per_type_counters(tmp_path):
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  model0 = port_rgnn()
  model = copy.deepcopy(model0)
  ref = gtt.loader.DistScanTrainer(port_typed_loader(), model, 3,
                                   chunk_size=2)
  with published(ref._feat) as want_stats:
    state, want, _ = ref.run_epoch(gtt.models.create_train_state(model,
                                                                 lr=1e-2))
  ckdir = str(tmp_path / 'ck')
  victim_model = copy.deepcopy(model0)
  victim = gtt.loader.DistScanTrainer(port_typed_loader(), victim_model, 3,
                                      chunk_size=2)
  ck = ChunkCheckpointer(ckdir, every=1).attach(victim)

  def crash(c, start, k):
    if c == 1:
      raise RuntimeError('injected')

  victim.stage_hook = crash
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(gtt.models.create_train_state(victim_model, lr=1e-2))
  ck.close()
  snap = ChunkCheckpointer(ckdir).latest()
  assert {'extra:stats:u', 'extra:stats:v'} <= set(snap.arrays)
  fresh_model = copy.deepcopy(model0)
  fresh = gtt.loader.DistScanTrainer(port_typed_loader(), fresh_model, 3,
                                     chunk_size=2)
  with published(fresh._feat) as got:
    _, losses, _ = ChunkCheckpointer(ckdir).resume_epoch(
        fresh, gtt.models.create_train_state(fresh_model, lr=1e-2))
  np.testing.assert_array_equal(losses, want.numpy())
  for x, y in zip(model.parameters(), fresh_model.parameters()):
    assert torch.equal(x, y)
  # the resumed epoch published the whole epoch's counters: the
  # snapshot's prefix and the replayed chunks'
  assert got == want_stats and all(s['lookups'] for s in got.values())
