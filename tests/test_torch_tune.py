"""The port's tuner (``graphlearn_tpu_torch.tune``) against the JAX
package's, on ``tests/test_tune.py``'s fixture (96 nodes, out-degree 4,
6 features, 3 classes; fanouts [3, 2] at batch 8 over a 44-seed pool).

Held exactly (tolerance 0): every probe's value and evidence dict; the
dataset fingerprint of the four dataset kinds (local, typed, stacked
distributed, typed distributed) built from the same COO; artifact JSON
both ways (a JAX-written artifact loads and validates against the port's
dataset, a port-written one in JAX), v1 and v2 files that JAX writes
upgraded alike; ``_pick_winner`` on the same records; the refusal message
classes (drifted dataset, wrong topology, padded candidates, typed cfg,
edited file, unknown keys and versions). The slice as a whole: JAX's
``tune()`` signs an artifact, the port loads it, and the port's
``ScanTrainer(config=art)`` runs two epochs from the JAX trainer's
weights: chunk size, steps and the sampler's counts exact, losses within
atol 1e-5 / rtol 1e-4. Then the port's own ``tune()`` on the CPU (its
candidates run eagerly, so nothing is captured: every compile count is
0), and ``RunTrainer`` / ``TieredScanTrainer`` / ``ServingEngine``
taking the artifact.
"""
import json

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu.tune import artifact as jart
from graphlearn_tpu.tune import probes as jprobes
from graphlearn_tpu.tune import tuner as jtuner
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.tune import artifact as tart
from graphlearn_tpu_torch.tune import probes as tprobes
from graphlearn_tpu_torch.tune import tuner as ttuner

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 96, 6, 3
FANOUTS = [3, 2]
BS = 8
TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]),
          rng.standard_normal((N, F)).astype(np.float32),
          rng.integers(0, C, N))


def jax_dataset(seed=0):
  ei, x, y = _inputs(seed)
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(x)
  ds.init_node_labels(y)
  return ds


def port_dataset(seed=0):
  ei, x, y = _inputs(seed)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(x)
  ds.init_node_labels(y)
  return ds


def seed_pool(num=44):
  return np.random.default_rng(9).permutation(N)[:num].astype(np.int64)


def loader_cfg(num=44, **kw):
  cfg = dict(fanouts=FANOUTS, input_nodes=seed_pool(num), batch_size=BS)
  cfg.update(kw)
  return cfg


@pytest.fixture(scope='module')
def jax_art():
  """JAX's tune() once for the module: the calibrated exact candidate
  alone (kernels off), so the artifact's mode is deterministic."""
  ds = jax_dataset()
  caps, _ = jprobes.probe_frontier_caps(ds.graph, FANOUTS, BS,
                                        input_nodes=seed_pool())
  cands = jtuner.default_candidates(caps, exact=True, kernels=False)
  return glt.tune(ds, loader_cfg(), exact=True, candidates=cands)


# ----------------------------------------------------------------- probes


def test_frontier_caps_probe_equals_jax():
  j = jprobes.probe_frontier_caps(jax_dataset().graph, FANOUTS, BS,
                                  input_nodes=seed_pool(), seed=3)
  t = tprobes.probe_frontier_caps(port_dataset().graph, FANOUTS, BS,
                                  input_nodes=seed_pool(), seed=3)
  assert t == j


@pytest.mark.parametrize('coverage,max_split', [(0.75, 0.5), (0.2, 0.5),
                                                (0.99, 0.1)])
def test_cache_split_probe_equals_jax(coverage, max_split):
  j = jprobes.probe_cache_split(jax_dataset().graph, N, coverage,
                                max_split)
  t = tprobes.probe_cache_split(port_dataset().graph, N, coverage,
                                max_split)
  assert t == j


@pytest.mark.parametrize('steps', [0, 1, 3, 6, 16, 24, 40, 64, 96, 100])
def test_chunk_k_probe_equals_jax(steps):
  assert tprobes.probe_chunk_k(steps) == jprobes.probe_chunk_k(steps)


@pytest.mark.parametrize('args', [(4, [24, 40], 8, 0.25), (16, [5], 3, 0.0),
                                  (1, [1000, 9000], 1024, 0.9)])
def test_slab_cap_probe_equals_jax(args):
  assert tprobes.probe_slab_cap(*args) == jprobes.probe_slab_cap(*args)


@pytest.mark.parametrize('batch', [1, 64, 300, 1024, 5000])
def test_serving_buckets_probe_equals_jax(batch):
  assert tprobes.probe_serving_buckets(batch) == \
      jprobes.probe_serving_buckets(batch)


@pytest.mark.parametrize('exact', [False, True])
def test_wire_dtype_and_epoch_steps_equal_jax(exact):
  assert tprobes.wire_dtype_choice(exact) == jprobes.wire_dtype_choice(exact)
  for n, b, d in ((44, 8, False), (44, 8, True), (16, 16, False)):
    assert tprobes.epoch_steps(n, b, d) == jprobes.epoch_steps(n, b, d)


# ------------------------------------------------------------ fingerprint


def _typed_local():
  from test_torch_hetero_loader import both_datasets
  return both_datasets()


def _stacked_dist():
  from test_torch_dist_scan import jax_loader, port_loader
  return (jax_loader(2, np.arange(8)).data, port_loader(2, np.arange(8)).data)


def _typed_dist():
  from test_torch_dist_hetero import typed_datasets
  return typed_datasets(2)


@pytest.mark.parametrize('kind', ['local', 'typed', 'dist', 'typed_dist'])
def test_dataset_fingerprint_equals_jax(kind):
  """Every dataset kind fingerprints alike in both packages, and never
  as None (a None turns validation into a warning)."""
  jds, tds = {'local': lambda: (jax_dataset(), port_dataset()),
              'typed': _typed_local, 'dist': _stacked_dist,
              'typed_dist': _typed_dist}[kind]()
  j = jart.dataset_fingerprint(jds)
  t = tart.dataset_fingerprint(tds)
  assert j is not None and t == j
  if kind in ('typed', 'typed_dist'):
    assert t['hetero'] is True
  if kind in ('dist', 'typed_dist'):
    assert t['num_partitions'] == 2
  # an artifact signed over one validates against the other
  art = tart.TuneArtifact(dict(chunk_k=4), j)
  art.validate_dataset(tds)
  jart.TuneArtifact.from_json(art.to_json()).validate_dataset(jds)


# ------------------------------------------------------------- artifacts


def test_jax_artifact_loads_and_validates_in_the_port(jax_art, tmp_path):
  path = str(tmp_path / 'jax.json')
  jax_art.save(path)
  art = gtt.tune.TuneArtifact.load(path)
  assert art.fingerprint == jax_art.fingerprint
  assert art.choices == jax_art.choices
  assert art.dataset == jax_art.dataset
  assert art.evidence == json.loads(json.dumps(jax_art.evidence))
  art.validate_dataset(port_dataset())
  assert art.loader_kwargs() == jax_art.loader_kwargs()
  assert art.kernel_kwargs() == jax_art.kernel_kwargs()
  assert art.trainer_kwargs() == jax_art.trainer_kwargs()
  assert art.serving_kwargs() == jax_art.serving_kwargs()
  assert art.topology_kwargs() == jax_art.topology_kwargs()
  # the port writes the same bytes back
  art.save(str(tmp_path / 'port.json'))
  assert open(tmp_path / 'port.json').read() == open(path).read()


def test_port_artifact_loads_and_validates_in_jax(tmp_path):
  choices = dict(mode='merge', frontier_caps=[16, 32], padded_window=None,
                 wire_dtype='bf16', chunk_k=4, split_ratio=0.25,
                 bucket_frac=0.5, slab_cap=128, serving_buckets=[16, 64],
                 batch_size=BS, fanouts=FANOUTS, exact=False,
                 use_pallas_v2=True, gather2_block_rows=128,
                 gather2_run_span=4, use_fused_hop=True,
                 fused_hop_window=256)
  tart_ = gtt.tune.TuneArtifact(choices, tart.dataset_fingerprint(
      port_dataset()), [dict(kind='winner', name='w')])
  path = str(tmp_path / 'port.json')
  tart_.save(path)
  jart_ = glt.tune.TuneArtifact.load(path)
  assert jart_.fingerprint == tart_.fingerprint
  assert jart_.choices == tart_.choices
  jart_.validate_dataset(jax_dataset())
  # the fused-hop keys round-trip; only the port's loader kwargs leave
  # them out (its hops route by device)
  assert 'use_fused_hop' in jart_.loader_kwargs()
  assert tart_.loader_kwargs() == {
      k: v for k, v in jart_.loader_kwargs().items()
      if k not in ('use_fused_hop', 'fused_hop_window')}


def _v1_choices():
  return dict(mode='merge', frontier_caps=[64, 128], padded_window=None,
              wire_dtype='bf16', chunk_k=4, split_ratio=0.1,
              bucket_frac=0.5, slab_cap=256, serving_buckets=[16, 64],
              batch_size=BS, fanouts=FANOUTS, exact=False)


@pytest.mark.parametrize('version', [1, 2])
def test_older_schema_files_upgrade_as_in_jax(version):
  choices = _v1_choices()
  if version == 2:
    choices.update(use_pallas_v2=True, gather2_block_rows=128,
                   gather2_run_span=4, use_fused_hop=False,
                   fused_hop_window=512)
  obj = dict(version=version, dataset=dict(num_nodes=N), choices=choices,
             evidence=[dict(kind='winner', name='old')],
             fingerprint=jart.compute_fingerprint(version, dict(num_nodes=N),
                                                  choices))
  assert tart.compute_fingerprint(version, dict(num_nodes=N), choices) == \
      obj['fingerprint']
  j = glt.tune.TuneArtifact.from_json(json.loads(json.dumps(obj)))
  t = gtt.tune.TuneArtifact.from_json(json.loads(json.dumps(obj)))
  assert t.to_json() == j.to_json()
  assert t.topology == 'local'
  for bad in (dict(obj, choices=dict(choices, chunk_k=999)),
              dict(obj, choices=dict(choices, topology='dist'))):
    for pkg in (glt, gtt):
      with pytest.raises(ValueError) as err:
        pkg.tune.TuneArtifact.from_json(bad)
    assert any(m in str(err.value) for m in ('edited',
                                             'unknown choice keys'))


def _raises_alike(jfn, tfn, match):
  with pytest.raises(ValueError, match=match) as je:
    jfn()
  with pytest.raises(ValueError, match=match) as te:
    tfn()
  return str(je.value), str(te.value)


def test_schema_refusals_equal_jax():
  for pkg_fn, match in (
      (lambda p: p.tune.TuneArtifact({'bogus_knob': 1}),
       'unknown choice keys'),
      (lambda p: p.tune.TuneArtifact(dict(topology='mesh')),
       'unknown topology'),
      (lambda p: p.tune.TuneArtifact.from_json({'version': 99,
                                                'choices': {}}),
       'unsupported tune-artifact version'),
      (lambda p: p.tune.TuneArtifact.from_json(dict(
          version=3, choices=dict(chunk_k=4), fingerprint='0' * 40)),
       'fingerprint mismatch')):
    j, t = _raises_alike(lambda: pkg_fn(glt), lambda: pkg_fn(gtt), match)
    assert t.replace('graphlearn_tpu_torch', 'graphlearn_tpu') == j


def test_loader_cfg_and_candidate_refusals_equal_jax():
  jd, td = jax_dataset(), port_dataset()
  for cfg, match in ((dict(input_nodes=seed_pool(), batch_size=8),
                      'fanouts'),
                     (dict(fanouts=FANOUTS, batch_size=8), 'input_nodes')):
    _raises_alike(lambda: glt.tune(jd, cfg), lambda: gtt.tune(td, cfg),
                  match)
  padded = [jtuner.Candidate('pad', dict(dedup='tree', padded_window=4))]
  tpadded = [ttuner.Candidate('pad', dict(dedup='tree', padded_window=4))]
  j, t = _raises_alike(
      lambda: glt.tune(jd, loader_cfg(), candidates=padded),
      lambda: gtt.tune(td, loader_cfg(), candidates=tpadded),
      'padded-window candidates')
  assert t == j
  with pytest.raises(ValueError, match='outside the profiled'):
    ttuner.kernel_candidates(tpadded[0], gather2_points=((100, 8),))
  with pytest.raises(ValueError, match='multiple of 128'):
    ttuner.kernel_candidates(tpadded[0], fused_hop_windows=(100,))


def test_typed_cfg_refusals_equal_jax():
  from test_torch_hetero_loader import FAN, both_datasets
  jds, tds = both_datasets()
  seeds = ('paper', np.arange(8))
  for cfg, match in (
      (dict(fanouts=[2, 2], input_nodes=seeds, batch_size=4),
       'fanouts'),
      (dict(fanouts=FAN, input_nodes=np.arange(8), batch_size=4),
       'input_nodes')):
    j, t = _raises_alike(lambda: glt.tune(jds, cfg),
                         lambda: gtt.tune(tds, cfg), match)
    assert t == j


def test_pick_winner_and_budget_ladder_equal_jax(monkeypatch):
  """The same records pick the same winner (least wall per step, the
  stable sort keeping field order on ties; the port's tie-break is the
  wall, JAX's too without GLT_PROGRAM_COST); the budget ladder keeps and
  drops the same candidates."""
  monkeypatch.delenv('GLT_PROGRAM_COST', raising=False)
  recs = [dict(name='a', qualified=True, wall_s=0.8, probe_steps=8),
          dict(name='b', qualified=False, wall_s=0.1, probe_steps=8,
               rejected='x'),
          dict(name='c', qualified=True, wall_s=0.4, probe_steps=4),
          dict(name='d', qualified=True, wall_s=0.8, probe_steps=8)]
  for order in (recs, recs[::-1], recs[:2] + recs[3:]):
    j = jtuner._pick_winner([dict(r) for r in order])
    t = ttuner._pick_winner([dict(r) for r in order])
    assert t == j
  bad = [dict(name='x', qualified=False, rejected='r')]
  with pytest.raises(RuntimeError, match='every candidate was disq'):
    ttuner._pick_winner(bad)
  from graphlearn_tpu.tune import topology as jtopo
  from graphlearn_tpu_torch.tune import topology as ttopo
  for budget, first in ((0.0, 1.0), (3.0, 1.0), (2.5, 0.5), (100.0, 0.0)):
    cj = [jtuner.Candidate(f'c{i}', {}) for i in range(5)]
    ct = [ttuner.Candidate(f'c{i}', {}) for i in range(5)]
    kj, ej = jtopo._budget_ladder([{}], cj, budget, first)
    kt, et = ttopo._budget_ladder([{}], ct, budget, first)
    assert et == ej and [c.name for c in kt] == [c.name for c in kj]


def test_candidate_fields_equal_jax():
  """The default fields: JAX's, less the fused-hop variant (the port
  routes its hops by device)."""
  for exact in (False, True):
    j = jtuner.default_candidates([16, 32], exact)
    t = ttuner.default_candidates([16, 32], exact)
    jn = [(c.name, c.loader_kwargs, c.kernel, c.exact_semantics) for c in j
          if not c.kernel.get('use_fused_hop')]
    assert [(c.name, c.loader_kwargs, c.kernel, c.exact_semantics)
            for c in t] == jn
  base = ttuner.default_candidates([16, 32], True)[0]
  probe = ttuner.retrace_probe_candidate(base)
  assert probe.perturb_chunk and probe.name == 'map_calibrated+retrace_probe'
  fans = {('a', 'to', 'b'): [4, 2], ('b', 'to', 'a'): [1, 1]}
  assert [(c.name, c.loader_kwargs) for c in
          ttuner.hetero_fanout_candidates(fans)] == \
      [(c.name, c.loader_kwargs) for c in
       jtuner.hetero_fanout_candidates(fans)]


# ----------------------------------------------------------- the slice


def _jax_trainer(art):
  loader = glt.loader.NeighborLoader(
      jax_dataset(), FANOUTS, seed_pool(), shuffle=True, seed=0,
      overflow_policy='off', **art.loader_kwargs())
  model = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(glt.loader.NeighborLoader(
      jax_dataset(), FANOUTS, seed_pool(), shuffle=True, seed=0,
      overflow_policy='off', **art.loader_kwargs()))))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0), first)
  return glt.loader.ScanTrainer(loader, model, tx, C, config=art), state


def test_jax_tuned_artifact_drives_the_port_scan_trainer(jax_art):
  """The slice: JAX signs, the port loads the JSON, validates it against
  its own dataset and trains two epochs from the JAX trainer's weights."""
  art = gtt.tune.TuneArtifact.from_json(json.loads(json.dumps(
      jax_art.to_json())))
  jtrainer, jstate = _jax_trainer(jax_art)
  model = gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu')
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  loader = gtt.loader.NeighborLoader(
      port_dataset(), FANOUTS, seed_pool(), shuffle=True, seed=0,
      overflow_policy='off', device='cpu', **art.loader_kwargs())
  trainer = gtt.loader.ScanTrainer(loader, model, C, config=art)
  assert trainer.chunk_size == jtrainer.chunk_size == art.choices['chunk_k']
  assert trainer._sampler.frontier_caps == jtrainer._sampler.frontier_caps
  state = ttrain.create_train_state(model)
  for _ in range(2):
    jstate, jlosses, jaccs = jtrainer.run_epoch(jstate)
    state, losses, accs = trainer.run_epoch(state)
    assert losses.shape == np.asarray(jlosses).shape
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), **TOL)
    assert trainer._sampler._call_count == jtrainer._sampler._call_count
    assert trainer._epochs == jtrainer._epochs
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)


def test_config_acceptors_refuse_as_jax_does(jax_art, tmp_path):
  """A drifted dataset (same shape, other edges), a mismatched topology,
  a store of another height, a tampered file: refused by the port's
  acceptors in JAX's words."""
  art = gtt.tune.TuneArtifact.from_json(jax_art.to_json())
  drifted = gtt.loader.NeighborLoader(port_dataset(seed=1), FANOUTS,
                                      seed_pool(), device='cpu',
                                      **art.loader_kwargs())
  model = gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu')
  with pytest.raises(ValueError, match='fingerprint mismatch'):
    gtt.loader.ScanTrainer(drifted, model, C, config=art)
  with pytest.raises(ValueError, match='fingerprint mismatch'):
    gtt.RunTrainer(drifted, model, C, epochs=2, config=art)
  dist = gtt.tune.TuneArtifact(dict(art.choices, topology='dist'),
                               art.dataset)
  good = gtt.loader.NeighborLoader(port_dataset(), FANOUTS, seed_pool(),
                                   device='cpu', **art.loader_kwargs())
  with pytest.raises(ValueError, match="tuned for topology 'dist'"):
    gtt.loader.ScanTrainer(good, model, C, config=dist)
  store = gtt.serving.EmbeddingStore(np.zeros((N + 8, 4), np.float32),
                                     device='cpu')
  with pytest.raises(ValueError, match='tuned for'):
    gtt.serving.ServingEngine(store, config=art)
  path = str(tmp_path / 'tampered.json')
  art.save(path)
  obj = json.load(open(path))
  obj['choices']['chunk_k'] = 999
  json.dump(obj, open(path, 'w'))
  with pytest.raises(ValueError, match='edited'):
    gtt.tune.TuneArtifact.load(path)


def test_port_tune_on_the_cpu_signs_a_jax_loadable_artifact(tmp_path):
  """The port's own tune() on the CPU: its probes' evidence is JAX's,
  every candidate qualifies with no capture (eager chunks), the artifact
  loads in JAX and drives RunTrainer, TieredScanTrainer and the serving
  engine (buckets, kernel routing) in the port."""
  ds = port_dataset()
  cands = ttuner.default_candidates([128, 128], exact=False)
  cands.append(ttuner.retrace_probe_candidate(cands[0]))
  art = gtt.tune(ds, loader_cfg(), candidates=cands,
                 out_path=str(tmp_path / 'a.json'))
  knobs = [e for e in art.evidence if 'knob' in e]
  jd = jax_dataset()
  caps, ev0 = jprobes.probe_frontier_caps(jd.graph, FANOUTS, BS,
                                          input_nodes=seed_pool())
  assert knobs[0] == ev0 and art.choices['frontier_caps'] == caps
  recs = [e for e in art.evidence if e.get('kind') == 'candidate']
  assert [r['name'] for r in recs] == [c.name for c in cands]
  for r in recs:
    assert r['qualified'], r
    assert sum(r['compile_epoch_compiles'].values()) == 0
    assert sum(r['steady_epoch_compiles'].values()) == 0
    assert r['compile_epochs'] == 1 and r['probe_steps'] == 4
  winner = [e for e in art.evidence if e.get('kind') == 'winner'][0]
  assert winner['tie_break'] == 'wall'
  j = glt.tune.TuneArtifact.load(str(tmp_path / 'a.json'))
  j.validate_dataset(jd)
  # RunTrainer and TieredScanTrainer adopt the tuned K
  loader = gtt.loader.NeighborLoader(ds, FANOUTS, seed_pool(), device='cpu',
                                     **art.loader_kwargs())
  model = gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu')
  run = gtt.RunTrainer(loader, model, C, epochs=2, config=art)
  assert run.chunk_size == art.choices['chunk_k']
  tds = port_dataset()
  tds.node_features = gtt.storage.TieredFeature(
      _inputs()[1], hot_rows=16, device='cpu')
  tl = gtt.loader.NeighborLoader(tds, FANOUTS, seed_pool(), device='cpu',
                                 **art.loader_kwargs())
  tiered = gtt.storage.TieredScanTrainer(tl, model, C, config=art)
  assert tiered.chunk_size == art.choices['chunk_k']
  tiered._stager.close()
  # the serving engine: the tuned buckets and the gather-v2 routing
  routed = gtt.tune.TuneArtifact(dict(art.choices, use_pallas_v2=True,
                                      gather2_block_rows=128,
                                      gather2_run_span=4), art.dataset)
  table = np.arange(N * 4, dtype=np.float32).reshape(N, 4)
  store = gtt.serving.EmbeddingStore(table, device='cpu')
  with gtt.serving.ServingEngine(store, config=routed) as eng:
    assert eng.buckets == tuple(art.choices['serving_buckets'])
    assert store.use_pallas_v2 and store.pallas_v2_block_rows == 128
    ids = np.array([5, 0, 95, 5, 17])
    np.testing.assert_array_equal(eng.submit(ids).result(timeout=30),
                                  table[ids])
