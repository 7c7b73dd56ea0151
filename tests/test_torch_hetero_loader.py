"""The port's typed loader, train step and typed examples against the JAX
package's.

- ``NeighborLoader(ds, fanouts, ('paper', ids))`` yields ``HeteroData``
  equal to the JAX loader's, batch for batch: ids, masks, counts,
  features (one row gather per featured type, or the hot/cold lookup of
  a store with a host part) and labels, in tree, calibrated merge, block
  and weighted modes, and with ``seed_labels_only``.
- The typed refusals: ``overflow_policy='recompute'``,
  ``frontier_caps='auto'`` and the epoch trainers.
- A typed train step's loss and updated parameters against optax's from
  a common state.
- ``examples/train_rgnn.py`` and ``examples/hierarchical_sage.py`` ported:
  the same losses as the JAX examples from the same weights.
"""
import argparse
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from test_torch_hetero_sampler import CITES, REV, SIZES, TAG, WRITES, \
    typed_edges

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAN = {CITES: [2, 2], WRITES: [2, 1], REV: [2, 1], TAG: [1, 0]}


def both_datasets(weights=False, split_ratio=1.0):
  edges, num_nodes, w = typed_edges()
  rng = np.random.default_rng(7)
  feats = {t: rng.standard_normal((n, 6)).astype(np.float32)
           for t, n in SIZES.items() if t != 'topic'}
  labels = {'paper': rng.integers(0, 3, SIZES['paper'])}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, edge_weights=w if weights else None,
                 graph_mode='CPU', num_nodes=num_nodes)
  jds.init_node_features(feats, split_ratio=split_ratio)
  jds.init_node_labels(labels)
  tds = gtt.data.Dataset(edge_dir='out', device='cpu')
  tds.init_graph(edges, edge_weights=w if weights else None,
                 num_nodes=num_nodes)
  tds.init_node_features(feats, split_ratio=split_ratio)
  tds.init_node_labels(labels)
  return jds, tds


def assert_hetero_data_equal(a, b):
  assert list(a.node) == list(b.node)
  for t in a.node:
    np.testing.assert_array_equal(np.asarray(a.node[t]), b.node[t].numpy())
    np.testing.assert_array_equal(np.asarray(a.num_nodes[t]),
                                  b.num_nodes[t].numpy())
    assert [int(c) for c in a.num_sampled_nodes[t]] == \
        [int(c) for c in b.num_sampled_nodes[t]]
  assert list(a.edge_index) == list(b.edge_index)
  for et in a.edge_index:
    np.testing.assert_array_equal(np.asarray(a.edge_index[et]),
                                  b.edge_index[et].numpy())
    np.testing.assert_array_equal(np.asarray(a.edge_mask[et]),
                                  b.edge_mask[et].numpy())
  assert sorted(a.x) == sorted(b.x)
  for t in a.x:
    np.testing.assert_array_equal(np.asarray(a.x[t]), b.x[t].numpy())
  assert sorted(a.y) == sorted(b.y)
  for t in a.y:
    np.testing.assert_array_equal(np.asarray(a.y[t]), b.y[t].numpy())
  for t in a.batch:
    np.testing.assert_array_equal(np.asarray(a.batch[t]),
                                  b.batch[t].numpy())
  assert a.batch_size == b.batch_size


LOADER_CASES = {
    'tree': dict(dedup='tree'),
    'merge_calibrated': dict(dedup='merge', calibrate=True),
    'block': dict(dedup='tree', strategy='block'),
    'weighted': dict(dedup='merge', with_weight=True),
    'seed_labels_only': dict(dedup='merge', seed_labels_only=True),
    'host_features': dict(dedup='tree', split_ratio=0.5),
}


@pytest.mark.parametrize('case', list(LOADER_CASES))
def test_typed_loader_batches_match_jax(case):
  kw = dict(LOADER_CASES[case])
  calibrate = kw.pop('calibrate', False)
  split = kw.pop('split_ratio', 1.0)
  jds, tds = both_datasets(weights=kw.get('with_weight', False),
                           split_ratio=split)
  if calibrate:
    kw['frontier_caps'] = glt.sampler.estimate_hetero_frontier_caps(
        jds.graph, FAN, {'paper': 16}, num_probes=4, slack=2.0,
        multiple=8)
  seeds = ('paper', np.arange(0, 120, 2))
  jl = glt.loader.NeighborLoader(jds, FAN, seeds, batch_size=16,
                                 shuffle=True, seed=3, **kw)
  tl = gtt.loader.NeighborLoader(tds, FAN, seeds, batch_size=16,
                                 shuffle=True, seed=3, device='cpu', **kw)
  n = 0
  for a, b in zip(jl, tl):
    assert isinstance(b, gtt.loader.HeteroData)
    assert_hetero_data_equal(a, b)
    if kw.get('seed_labels_only'):
      assert b.y['paper'].shape[0] == 16 and 'author' not in b.y
    n += 1
  assert n == len(tl) == len(jl) == 4
  assert tl.sampler._call_count == jl.sampler._call_count


def test_typed_loader_refusals_in_jax_words():
  """``overflow_policy='recompute'`` (typed batches have no replayable
  key) and ``frontier_caps='auto'`` (typed caps come from
  ``estimate_hetero_frontier_caps``) are refused on typed datasets, as
  in JAX (tests/test_loader.py:447, :520), and so are typed loaders by
  the epoch trainers."""
  jds, tds = both_datasets()
  caps = gtt.sampler.estimate_hetero_frontier_caps(tds.graph, FAN,
                                                   {'paper': 8})
  for pkg, ds, kw in ((glt, jds, {}), (gtt, tds, dict(device='cpu'))):
    with pytest.raises(ValueError, match='homogeneous-only'):
      pkg.loader.NeighborLoader(ds, FAN, ('paper', np.arange(8)),
                                batch_size=8, dedup='merge',
                                frontier_caps=caps,
                                overflow_policy='recompute', **kw)
    with pytest.raises(ValueError, match='homogeneous-only'):
      pkg.loader.NeighborLoader(ds, FAN, ('paper', np.arange(8)),
                                batch_size=8, dedup='merge',
                                frontier_caps='auto', **kw)
  # the epoch trainers are homogeneous, as JAX's local ones: typed
  # batches train in the per-step loop
  loader = gtt.loader.NeighborLoader(tds, FAN, ('paper', np.arange(8)),
                                     batch_size=8, device='cpu')
  model = gtt.models.RGNN(tuple(glt.typing.reverse_edge_type(et)
                                for et in FAN), {'paper': 6, 'author': 6},
                          8, 3, out_ntype='paper', device='cpu')
  for trainer in (gtt.loader.ScanTrainer, gtt.loader.RunTrainer,
                  gtt.loader.OverlappedTrainer):
    with pytest.raises(ValueError, match='homogeneous-only'):
      trainer(loader, model, 3)


@pytest.mark.parametrize('conv,mode', [('sage', 'tree_dense'),
                                       ('gat', 'tree_dense'),
                                       ('gat', 'merge_dense'),
                                       ('sage', 'segment')])
def test_typed_train_step_matches_optax(conv, mode):
  """From a common state (flax weights and a mid-run Adam state carried
  into torch), three typed train steps give optax's losses and updated
  parameters (atol 1e-5, rtol 1e-4)."""
  import jax
  import optax
  caps = None
  if mode == 'merge_dense':
    caps = glt.sampler.estimate_hetero_frontier_caps(
        both_datasets()[0].graph, FAN, {'paper': 8}, num_probes=6,
        slack=1.5, multiple=4)
  jds, tds = both_datasets()
  dedup = 'merge' if mode == 'merge_dense' else 'tree'
  seeds = ('paper', np.arange(0, 120, 3))
  jl = glt.loader.NeighborLoader(jds, FAN, seeds, batch_size=8, seed=0,
                                 dedup=dedup, frontier_caps=caps)
  tl = gtt.loader.NeighborLoader(tds, FAN, seeds, batch_size=8, seed=0,
                                 dedup=dedup, frontier_caps=caps,
                                 device='cpu')
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN, etype_caps=caps)
  kw = {} if mode == 'segment' else dict(hop_node_offsets=no,
                                         hop_edge_offsets=eo)
  if mode != 'segment':
    kw.update({mode: True, 'tree_records': recs})
  msg = tuple(glt.typing.reverse_edge_type(et) for et in FAN)
  jm = glt.models.RGNN(etypes=msg, hidden_dim=8, out_dim=3, num_layers=2,
                       out_ntype='paper', conv=conv, heads=2, **kw)
  jbatches = [jb for jb, _ in zip(jl, range(3))]
  tbatches = [tb for tb, _ in zip(tl, range(3))]

  def jdict(b):
    return dict(x=b.x, edge_index=b.edge_index, edge_mask=b.edge_mask,
                y=b.y['paper'], num_seed_nodes=b.num_sampled_nodes['paper'][0])

  params = jm.init(jax.random.PRNGKey(0), jbatches[0].x,
                   jbatches[0].edge_index, jbatches[0].edge_mask)
  tx = optax.adam(3e-3)
  state = jtrain.TrainState(params, tx.init(params), 0)
  jstep, _ = jtrain.make_train_step(jm, tx, 3)
  state, _, _ = jstep(state, jdict(jbatches[0]))     # a mid-run state
  tm = gtt.models.RGNN(msg, {'paper': 6, 'author': 6}, 8, 3, conv=conv,
                       heads=2, out_ntype='paper', device='cpu', **kw)
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, state.params), tm), strict=False)
  tstate = ttrain.create_train_state(tm, lr=3e-3)
  adam = state.opt_state[0]
  convert.adam_state_from_optax(tstate.optimizer, tm, (
      adam.count, jax.tree.map(np.asarray, adam.mu),
      jax.tree.map(np.asarray, adam.nu)))
  tstep, _ = ttrain.make_train_step(tm, 3)
  for jb, tb in zip(jbatches, tbatches):
    state, jloss, _ = jstep(state, jdict(jb))
    tbatch = ttrain.batch_to_dict(tb)
    assert tbatch['y'] is tb.y['paper']
    tstate, tloss, _ = tstep(tstate, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                               atol=1e-5)
  want = convert.params_from_flax(jax.tree.map(np.asarray, state.params),
                                  tm)
  for name, p in tm.named_parameters():
    if name in want:
      np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                 rtol=1e-4, atol=1e-5, err_msg=name)
  count, mu, _ = convert.adam_state_to_optax(tstate.optimizer, tm)
  assert count == int(state.opt_state[0].count) == 4
  jmu = jax.tree.map(np.asarray, state.opt_state[0].mu)
  for name, t in convert.params_from_flax(mu, tm).items():
    np.testing.assert_allclose(
        t.numpy(), convert.params_from_flax(jmu, tm)[name].numpy(),
        rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------ examples


def _load_jax_example(rel, name):
  spec = importlib.util.spec_from_file_location(name, ROOT / rel)
  mod = importlib.util.module_from_spec(spec)
  sys.path.insert(0, str((ROOT / rel).parent))
  try:
    spec.loader.exec_module(mod)
  finally:
    sys.path.remove(str((ROOT / rel).parent))
  return mod


def _record_inits(monkeypatch):
  """Every ``RGNN.init`` result of a JAX run, as numpy trees, in order."""
  import jax
  inits = []
  init = glt.models.RGNN.init

  def recording_init(self, *a, **kw):
    params = init(self, *a, **kw)
    inits.append(jax.tree.map(np.asarray, params))
    return params

  monkeypatch.setattr(glt.models.RGNN, 'init', recording_init)
  monkeypatch.setattr(glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  return inits


@pytest.mark.parametrize('model', ['rsage', 'rgat'])
def test_train_rgnn_example_matches_jax(model, monkeypatch, capsys):
  """The ported IGBH RGNN example from the JAX example's initial weights:
  the same first and final loss (the JAX example prints them to 4
  places)."""
  import json
  from graphlearn_tpu_torch.examples import train_rgnn as example
  argv = ['--epochs', '1', '--n-paper', '1500', '--n-author', '700',
          '--batch-size', '32', '--hidden', '16', '--model', model]
  inits = _record_inits(monkeypatch)
  mod = _load_jax_example('examples/igbh/train_rgnn.py', 'jax_train_rgnn')
  monkeypatch.setattr(sys, 'argv', ['train_rgnn.py'] + argv)
  mod.main()
  jres = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  args = argparse.Namespace(epochs=1, n_paper=1500, n_author=700,
                            batch_size=32, hidden=16, lr=3e-3, model=model,
                            seed=0, device='cpu')
  tres, losses = example.run(args, inits[0])
  assert tres['steps_per_epoch'] == 4 == len(losses)
  assert abs(losses[0] - jres['first_loss']) <= 1e-4
  assert abs(losses[-1] - jres['final_loss']) <= 2e-4
  assert abs(tres['final_train_acc'] - jres['final_train_acc']) <= 1e-4


def test_hierarchical_sage_example_matches_jax(monkeypatch, capsys):
  """The ported hierarchical typed SAGE example from the JAX example's
  initial weights of both variants: the same first and final losses."""
  import json
  from graphlearn_tpu_torch.examples import hierarchical_sage as example
  argv = ['--epochs', '1', '--n-paper', '600', '--batch-size', '32',
          '--hidden', '16']
  inits = _record_inits(monkeypatch)
  mod = _load_jax_example('examples/hetero/hierarchical_sage.py',
                          'jax_hierarchical_sage')
  monkeypatch.setattr(sys, 'argv', ['hierarchical_sage.py'] + argv)
  mod.main()
  jres = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  args = argparse.Namespace(epochs=1, n_paper=600, batch_size=32,
                            hidden=16, lr=3e-3, seed=0, device='cpu')
  tres, losses = example.run(args, {'full': inits[0],
                                    'hierarchical': inits[1]})
  for name in ('full', 'hierarchical'):
    assert len(losses[name]) == 3
    assert abs(losses[name][0] - jres[name]['first_loss']) <= 1e-4, name
    assert abs(losses[name][-1] - jres[name]['final_loss']) <= 2e-4, name
  assert abs(losses['full'][0] - losses['hierarchical'][0]) <= 1e-4
