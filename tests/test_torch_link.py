"""The port's link prediction path against the JAX package, on the CPU.

- ``NeighborSampler.sample_from_edges`` with binary, triplet and no
  negatives (labels given or not), on the tree, merge, ``map_table`` and
  ``sort_legacy`` engines, with ``with_edge``, and on a CSC graph
  (``edge_dir='in'``): every field and every metadata array equal.
- ``LinkNeighborLoader`` epochs (shuffle, ``frontier_caps='auto'``
  calibrated at ``link_seed_width``), the overflow replay at full caps on
  the same key, and a ``state_dict`` resume that replays the same
  batches.
- ``make_link_train_step``: 4 steps from carried flax weights against the
  JAX step (loss, accuracy, parameters within rtol 1e-4 / atol 1e-5).
- The port's ``graph_sage_unsup`` example against the JAX example (the
  JAX module run as it is, its steps recorded): the same steps and every
  per-step loss of one epoch within rtol 1e-4 (at 2,000 nodes of average
  degree 1: ~56 steps; over hundreds of steps Adam turns the two stacks'
  rounding differences into diverging trajectories).
"""
import argparse
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.examples import graph_sage_unsup as example
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge', 'edge_mask', 'batch')
ENGINES = ('tree', 'auto', 'map_table', 'sort_legacy')


def _np(v):
  return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_outputs_equal(a, b, what=''):
  """A JAX and a port ``SamplerOutput``: fields, counts, metadata."""
  for f in FIELDS:
    x, y = getattr(a, f), getattr(b, f)
    assert (x is None) == (y is None), (what, f)
    if x is not None:
      np.testing.assert_array_equal(_np(y), _np(x), err_msg=f'{what} {f}')
  assert a.batch_size == b.batch_size
  for f in ('num_sampled_nodes', 'num_sampled_edges'):
    assert [int(c) for c in getattr(a, f)] == \
        [int(c) for c in getattr(b, f)], (what, f)
  assert sorted(a.metadata) == sorted(b.metadata), what
  for k in a.metadata:
    np.testing.assert_array_equal(_np(b.metadata[k]), _np(a.metadata[k]),
                                  err_msg=f'{what} {k}')


def _graphs(n=70, e=600, seed=0, layout='CSR'):
  rng = np.random.default_rng(seed)
  ei = rng.integers(0, n, (2, e))
  ei[:, 40:60] = ei[:, 0:20]           # repeated (row, col) pairs
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n, layout=layout),
                      'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n, layout=layout),
                      device='cpu')
  return ei, jg, tg


def _neg(pkg, mode, amount):
  return None if mode is None else pkg.sampler.NegativeSampling(mode, amount)


@pytest.mark.parametrize('dedup', ENGINES)
@pytest.mark.parametrize('neg', [('binary', 1), ('triplet', 2), (None, 0),
                                 ('binary', 1.5)])
def test_sample_from_edges_matches_jax(dedup, neg):
  ei, jg, tg = _graphs()
  js = glt.sampler.NeighborSampler(jg, [3, 2], seed=4, dedup=dedup,
                                   with_edge=True)
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=4, dedup=dedup,
                                   with_edge=True, device='cpu')
  rng = np.random.default_rng(1)
  for step in range(3):
    pick = rng.integers(0, ei.shape[1], 6)
    label = (rng.integers(0, 2, 6) if step == 1 else None)
    a = js.sample_from_edges(glt.sampler.EdgeSamplerInput(
        ei[0][pick], ei[1][pick], label, neg_sampling=_neg(glt, *neg)))
    b = ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
        ei[0][pick], ei[1][pick], label, neg_sampling=_neg(gtt, *neg)))
    assert_outputs_equal(a, b, (dedup, neg, step))
    node = b.node.numpy()
    if neg[0] != 'triplet':
      eli = b.metadata['edge_label_index'].numpy()
      np.testing.assert_array_equal(node[eli[0, :6]], ei[0][pick])
      np.testing.assert_array_equal(node[eli[1, :6]], ei[1][pick])
  assert ts._call_count == js._call_count == 3


def test_sample_from_edges_csc_flip_matches_jax():
  """``edge_dir='in'``: the CSC's negatives flip to (src, dst)."""
  ei, jg, tg = _graphs(layout='CSC')
  js = glt.sampler.NeighborSampler(jg, [3], seed=9, edge_dir='in',
                                   with_edge=True)
  ts = gtt.sampler.NeighborSampler(tg, [3], seed=9, edge_dir='in',
                                   with_edge=True, device='cpu')
  for _ in range(2):
    a = js.sample_from_edges(glt.sampler.EdgeSamplerInput(
        ei[0][:8], ei[1][:8], neg_sampling=glt.sampler.NegativeSampling()))
    b = ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
        ei[0][:8], ei[1][:8], neg_sampling=gtt.sampler.NegativeSampling()))
    assert_outputs_equal(a, b, 'csc')


def test_sample_from_edges_explicit_key_replays():
  """One key splits into the negatives' and the nodes' keys: the same key
  gives the same batch, and a link batch's hop keys are not a node
  batch's."""
  _, _, tg = _graphs()
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=1, device='cpu')
  key = gtt.random.fold_in(gtt.random.PRNGKey(1), 5)
  inp = gtt.sampler.EdgeSamplerInput(
      np.arange(4), np.arange(4) + 1,
      neg_sampling=gtt.sampler.NegativeSampling())
  a = ts.sample_from_edges(inp, key=key)
  b = ts.sample_from_edges(inp, key=key)
  for f in ('node', 'row', 'col'):
    assert torch.equal(getattr(a, f), getattr(b, f))
  assert ts._call_count == 0
  seeds = a.batch[:16].numpy()
  c = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds), key=key)
  _, knode = gtt.random.split(key)
  d = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds), key=knode)
  assert torch.equal(d.node, a.node) and not torch.equal(c.node, a.node)


def _datasets(n=80, e=700, seed=3, feat_dim=6):
  rng = np.random.default_rng(seed)
  ei = rng.integers(0, n, (2, e))
  feat = rng.standard_normal((n, feat_dim)).astype(np.float32)
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  jds.init_node_features(feat)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=n)
  tds.init_node_features(feat)
  return ei, jds, tds


def _batches_equal(jb, tb, what):
  assert len(jb) == len(tb), what
  for i, (a, b) in enumerate(zip(jb, tb)):
    for f in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x', 'batch'):
      np.testing.assert_array_equal(_np(getattr(b, f)), _np(getattr(a, f)),
                                    err_msg=f'{what} {i} {f}')
    for k in a.metadata:
      np.testing.assert_array_equal(_np(b.metadata[k]), _np(a.metadata[k]),
                                    err_msg=f'{what} {i} {k}')


@pytest.mark.parametrize('kw', [dict(), dict(dedup='merge',
                                             frontier_caps='auto'),
                                dict(dedup='tree')])
def test_link_neighbor_loader_epochs_match_jax(kw):
  ei, jds, tds = _datasets()
  pool = ei[:, :50]

  def loaders():
    jl = glt.loader.LinkNeighborLoader(
        jds, [3, 2], pool, neg_sampling=glt.sampler.NegativeSampling(),
        batch_size=8, shuffle=True, seed=5, **kw)
    tl = gtt.loader.LinkNeighborLoader(
        tds, [3, 2], pool, neg_sampling=gtt.sampler.NegativeSampling(),
        batch_size=8, shuffle=True, seed=5, device='cpu', **kw)
    return jl, tl

  jl, tl = loaders()
  if 'frontier_caps' in kw:
    assert list(tl.sampler.frontier_caps) == list(jl.sampler.frontier_caps)
    assert tl.sampler.clamped_exact
  for epoch in range(2):
    _batches_equal(list(jl), list(tl), (kw, epoch))
  assert len(tl) == len(jl) == 7


def test_link_seed_width_and_typed_seeds_match_jax():
  from graphlearn_tpu.sampler import calibrate as jcal
  from graphlearn_tpu import typing as jtyping
  for neg in (None, ('binary', 1), ('binary', 0.5), ('triplet', 3)):
    jn = None if neg is None else glt.sampler.NegativeSampling(*neg)
    tn = None if neg is None else gtt.sampler.NegativeSampling(*neg)
    assert gtt.sampler.calibrate.link_seed_width(12, tn) == \
        jcal.link_seed_width(12, jn)
  for value in (np.zeros((2, 3)), (('a', 'r', 'b'), np.zeros((2, 3))),
                (np.arange(3), np.arange(3)), (('a', 'b', 1), 5)):
    a = jtyping.split_edge_type_seeds(value)
    b = gtt.typing.split_edge_type_seeds(value)
    assert a[0] == b[0] and a[1] is b[1]
  _, _, tds = _datasets()
  with pytest.raises(ValueError, match='homogeneous-only'):
    gtt.loader.LinkNeighborLoader(tds, [2], (('a', 'r', 'b'), np.zeros(
        (2, 4), np.int64)), batch_size=2, frontier_caps='auto',
                                  device='cpu')
  with pytest.raises(ValueError, match='pass a list'):
    gtt.loader.LinkNeighborLoader(tds, [2], np.zeros((2, 4), np.int64),
                                  batch_size=2, frontier_caps='some',
                                  device='cpu')
  with pytest.raises(ValueError, match='legacy'):
    gtt.loader.LinkNeighborLoader(tds, [2], np.zeros((2, 4), np.int64),
                                  batch_size=2, dedup='map_table',
                                  frontier_caps=[4], device='cpu')


def test_link_loader_overflow_recompute_matches_jax():
  """Caps too small: each batch replays at full caps on its own key and
  equals the uncapped loader's (negatives included), as in JAX."""
  ei, jds, tds = _datasets(n=16, e=120)
  rows = np.arange(16)
  cols = (rows * 5 + 2) % 16

  def mk(pkg, ds, **kw):
    extra = {} if pkg is glt else dict(device='cpu')
    return pkg.loader.LinkNeighborLoader(
        ds, [2], np.stack([rows, cols]),
        neg_sampling=pkg.sampler.NegativeSampling('triplet', 1.0),
        batch_size=4, shuffle=False, seed=0, dedup='merge', **kw, **extra)

  fix = mk(gtt, tds, frontier_caps=[1], overflow_policy='recompute')
  ref = mk(gtt, tds, overflow_policy='off')
  jfix = mk(glt, jds, frontier_caps=[1], overflow_policy='recompute')
  got, want, jgot = list(fix), list(ref), list(jfix)
  _batches_equal(want, got, 'replay')
  _batches_equal(jgot, got, 'jax replay')
  assert fix.overflow_recomputes == jfix.overflow_recomputes == len(got) > 0
  raising = mk(gtt, tds, frontier_caps=[1])
  with pytest.raises(RuntimeError, match='overflowed'):
    list(raising)


def test_link_loader_resume_replays_identical_batches():
  ei, jds, tds = _datasets()

  def mk():
    return gtt.loader.LinkNeighborLoader(
        tds, [2], ei, neg_sampling=gtt.sampler.NegativeSampling(),
        batch_size=64, shuffle=True, seed=3, device='cpu')

  loader = mk()
  it = iter(loader)
  for _ in range(3):
    next(it)
  state = loader.state_dict()
  cont = list(it) + list(loader)
  resumed = mk()
  resumed.load_state_dict(state)
  again = list(resumed) + list(resumed)
  assert len(cont) == len(again) == len(loader) * 2 - 3
  for a, b in zip(cont, again):
    assert torch.equal(a.node, b.node)
    assert torch.equal(a.metadata['edge_label_index'],
                       b.metadata['edge_label_index'])
  # the JAX loader's continuation from the same point is the same
  jl = glt.loader.LinkNeighborLoader(
      jds, [2], ei, neg_sampling=glt.sampler.NegativeSampling(),
      batch_size=64, shuffle=True, seed=3)
  jit = iter(jl)
  for _ in range(3):
    next(jit)
  _batches_equal(list(jit) + list(jl), cont, 'jax continuation')


def test_fused_epoch_trainers_refuse_link_batches():
  ei, _, tds = _datasets()
  tds.init_node_labels(np.zeros(80, np.int64))
  loader = gtt.loader.LinkNeighborLoader(tds, [2], ei, batch_size=8,
                                         device='cpu')
  model = gtt.models.GraphSAGE(6, 8, 3, num_layers=1, device='cpu')
  with pytest.raises(ValueError, match='per-step loop'):
    gtt.loader.ScanTrainer(loader, model, 3)


def test_link_train_step_matches_jax():
  ei, jds, tds = _datasets(feat_dim=8)
  pool = ei[:, :64]
  jl = glt.loader.LinkNeighborLoader(
      jds, [3, 2], pool, neg_sampling=glt.sampler.NegativeSampling(),
      batch_size=16, shuffle=True, seed=2)
  tl = gtt.loader.LinkNeighborLoader(
      tds, [3, 2], pool, neg_sampling=gtt.sampler.NegativeSampling(),
      batch_size=16, shuffle=True, seed=2, device='cpu')
  jb, tb = list(jl), list(tl)
  assert len(jb) == len(tb) == 4
  jm = JaxSAGE(hidden_dim=16, out_dim=16, num_layers=2)
  state, tx = jtrain.create_train_state(
      jm, jax.random.PRNGKey(0), jtrain.link_batch_to_dict(jb[0]), lr=3e-3)
  jstep, jeval = jtrain.make_link_train_step(jm, tx)
  tm = gtt.models.GraphSAGE(8, 16, 16, num_layers=2, device='cpu')
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, state.params)))
  tstate = ttrain.create_train_state(tm, lr=3e-3)
  tstep, teval = ttrain.make_link_train_step(tm)
  for a, b in zip(jb, tb):
    state, jloss, jacc = jstep(state, jtrain.link_batch_to_dict(a))
    tstate, tloss, tacc = tstep(tstate, ttrain.link_batch_to_dict(b))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-4,
                               atol=1e-5)
  want = convert.params_from_flax(jax.tree.map(np.asarray, state.params))
  for name, p in tm.state_dict().items():
    np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)
  np.testing.assert_allclose(
      float(teval(tstate, ttrain.link_batch_to_dict(tb[0]))),
      float(jeval(state, jtrain.link_batch_to_dict(jb[0]))), rtol=1e-4)
  assert tstate.step == 4


def _jax_example_run(monkeypatch, argv):
  """The JAX example's ``main`` as it is, with its initial parameters and
  per-step losses recorded."""
  spec = importlib.util.spec_from_file_location(
      'jax_graph_sage_unsup', ROOT / 'examples' / 'graph_sage_unsup.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  rec = {'losses': []}
  create, make_step = jtrain.create_train_state, jtrain.make_link_train_step

  def create_and_record(*a, **kw):
    state, tx = create(*a, **kw)
    rec['params0'] = jax.tree.map(np.asarray, state.params)
    return state, tx

  def make_recording_step(*a, **kw):
    step, eval_step = make_step(*a, **kw)

    def recording_step(state, batch):
      out = step(state, batch)
      rec['losses'].append(float(out[1]))
      return out

    return recording_step, eval_step

  monkeypatch.setattr(jtrain, 'create_train_state', create_and_record)
  monkeypatch.setattr(jtrain, 'make_link_train_step', make_recording_step)
  monkeypatch.setattr(glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  monkeypatch.setattr(sys, 'argv', ['graph_sage_unsup.py'] + argv)
  mod.main()
  return rec


def test_example_losses_track_the_jax_example(monkeypatch):
  argv = ['--epochs', '1', '--num-nodes', '2000', '--batch-size', '64',
          '--avg-deg', '1']
  rec = _jax_example_run(monkeypatch, argv)
  args = argparse.Namespace(epochs=1, num_nodes=2000, avg_deg=1,
                            batch_size=64, hidden=128, lr=3e-3, seed=0,
                            device='cpu')
  result, losses = example.run(args, rec['params0'])
  assert len(losses) == len(rec['losses']) == result['steps_per_epoch']
  assert result['steps_per_epoch'] > 40
  np.testing.assert_allclose(losses, rec['losses'], rtol=1e-4, atol=0)
  assert np.isfinite(losses).all()
