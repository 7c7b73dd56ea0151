"""Training in the port against the JAX package and optax.

- ``random.permutation`` bit-equal to ``jax.random.permutation`` on both
  sides of the step from one sort round to two (n = 1,625 / 1,627).
- ``make_loss_fn``: loss and accuracy against the JAX loss on a ragged
  batch whose pad slots and one seed slot carry labels outside
  ``[0, C)``.
- Three train steps (tree, merge and segment forwards) from converted
  flax params against ``make_train_step`` + ``optax.adam``.
- Adam state through ``models.convert`` and back, and a JAX-started run
  resumed in the port.
- The products example in synthetic mode on the CPU.

Losses, accuracies and parameters agree within atol=1e-5, rtol=1e-4 (the
two frameworks sum in other orders; Adam's bias corrections are placed
differently).
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, F, C = 300, 16, 5
FANOUTS = [4, 3]
BATCH = 16
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('n', [1, 44, 1625, 1627, 5000])
def test_permutation_bit_equal(n):
  for seed, epoch in ((0, 0), (11, 3)):
    jkey = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), 0xFFFFFFFF), epoch)
    tkey = gtt.random.fold_in(gtt.random.fold_in(
        gtt.random.PRNGKey(seed), 0xFFFFFFFF), epoch)
    ref = np.asarray(jax.random.permutation(jkey, n))
    got = gtt.random.permutation(tkey, n, device='cpu')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _data(seed=0):
  rng = np.random.default_rng(seed)
  e = 2400
  rows = rng.integers(0, N, e)
  cols = np.empty(e, np.int64)
  cols[:e // 2] = rng.integers(0, N, e // 2)
  cols[e // 2:] = rng.zipf(1.5, e - e // 2) % N
  feats = rng.standard_normal((N, F)).astype(np.float32)
  labels = rng.integers(0, C, N).astype(np.int32)
  seeds = rng.permutation(N)[:56]     # 3 full batches + a ragged tail
  return np.stack([rows, cols]), feats, labels, seeds


def _pair(mode, seeds=None):
  """(JAX loader, port loader, JAX model, port model) over one graph."""
  ei, feats, labels, pool = _data()
  pool = pool if seeds is None else seeds
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=N, graph_mode='CPU')
  jds.init_node_features(feats)
  jds.init_node_labels(labels)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=N)
  tds.init_node_features(feats)
  tds.init_node_labels(labels)
  dedup = 'merge' if mode == 'merge' else 'tree'
  caps = [48, 96] if mode == 'merge' else None
  jl = glt.loader.NeighborLoader(jds, FANOUTS, pool, batch_size=BATCH,
                                 shuffle=False, seed=3, dedup=dedup,
                                 frontier_caps=caps)
  tl = gtt.loader.NeighborLoader(tds, FANOUTS, pool, batch_size=BATCH,
                                 shuffle=False, seed=3, dedup=dedup,
                                 frontier_caps=caps, device='cpu')
  if mode == 'segment':
    jm = JaxSAGE(hidden_dim=32, out_dim=C, num_layers=2)
    tm = gtt.models.GraphSAGE(F, 32, C, num_layers=2, device='cpu')
  else:
    if mode == 'merge':
      no, eo = jtrain.merge_hop_offsets(BATCH, FANOUTS, frontier_caps=caps)
      assert (no, eo) == ttrain.merge_hop_offsets(BATCH, FANOUTS, frontier_caps=caps)
    else:
      no, eo = jtrain.tree_hop_offsets(BATCH, FANOUTS)
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo, fanouts=FANOUTS,
              tree_dense=mode == 'tree', merge_dense=mode == 'merge')
    jm = JaxSAGE(hidden_dim=32, out_dim=C, num_layers=2,
                 **dict(kw, fanouts=tuple(FANOUTS)))
    tm = gtt.models.GraphSAGE(F, 32, C, num_layers=2, device='cpu', **kw)
  return jl, tl, jm, tm


def _init(jm, tm, jd):
  params = jm.init(jax.random.PRNGKey(0), jd['x'], jd['edge_index'],
                   jd['edge_mask'])
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  return params


def _assert_params_close(tm, params):
  want = convert.params_from_flax(jax.tree.map(np.asarray, params))
  got = tm.state_dict()
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                               err_msg=name, **TOL)


def test_loss_matches_jax_on_a_ragged_batch_with_unknown_labels():
  jl, tl, jm, tm = _pair('tree')
  jb, tb = list(jl)[-1], list(tl)[-1]     # the ragged tail: 8 of 16 seeds
  jd, td = jtrain.batch_to_dict(jb), ttrain.batch_to_dict(tb)
  assert int(td['num_seed_nodes']) == 56 - 3 * BATCH
  params = _init(jm, tm, jd)
  y = np.asarray(jd['y']).copy()
  y[BATCH - 1] = C + 3           # a pad slot past the seeds
  y[BATCH - 2] = -1
  y[2] = C                       # a seed whose label no class matches
  jd = dict(jd, y=jax.numpy.asarray(y))
  td = dict(td, y=torch.as_tensor(y))
  jloss, jacc = jtrain.make_loss_fn(jm, C)(params, jd)
  with torch.no_grad():
    tloss, tacc = ttrain.make_loss_fn(tm, C)(td)
  assert tloss.dtype == tacc.dtype == torch.float32
  np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  np.testing.assert_allclose(float(tacc), float(jacc), **TOL)
  # eval_step is the accuracy alone
  _, eval_step = ttrain.make_train_step(tm, C)
  state = ttrain.create_train_state(tm)
  np.testing.assert_allclose(float(eval_step(state, td)), float(jacc), **TOL)


@pytest.mark.parametrize('mode', ['tree', 'merge', 'segment'])
def test_train_steps_match_optax(mode):
  jl, tl, jm, tm = _pair(mode)
  pairs = list(zip(jl, tl))[:3]
  jd0 = jtrain.batch_to_dict(pairs[0][0])
  params = _init(jm, tm, jd0)
  jstate, tx = jtrain.create_train_state(jm, jax.random.PRNGKey(0), jd0,
                                         lr=3e-3)
  jstate = jstate._replace(params=params, opt_state=tx.init(params))
  jstep, _ = jtrain.make_train_step(jm, tx, C)
  tstate = ttrain.create_train_state(tm, lr=3e-3)
  tstep, _ = ttrain.make_train_step(tm, C)
  for jb, tb in pairs:
    jd, td = jtrain.batch_to_dict(jb), ttrain.batch_to_dict(tb)
    np.testing.assert_array_equal(np.asarray(jd['x']), td['x'].numpy())
    jstate, jloss, jacc = jstep(jstate, jd)
    tstate, tloss, tacc = tstep(tstate, td)
    assert not tloss.requires_grad
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tacc), float(jacc), **TOL)
  assert tstate.step == int(jstate.step) == 3
  _assert_params_close(tm, jstate.params)


def test_adam_state_round_trip_and_resume_from_jax():
  jl, tl, jm, tm = _pair('merge')
  pairs = list(zip(jl, tl))
  jd0 = jtrain.batch_to_dict(pairs[0][0])
  params = _init(jm, tm, jd0)
  jstate, tx = jtrain.create_train_state(jm, jax.random.PRNGKey(0), jd0)
  jstate = jstate._replace(params=params, opt_state=tx.init(params))
  jstep, _ = jtrain.make_train_step(jm, tx, C)
  for jb, _ in pairs[:2]:              # two steps in JAX
    jstate, _, _ = jstep(jstate, jtrain.batch_to_dict(jb))
  adam = jax.tree.map(np.asarray, jstate.opt_state[0])
  assert isinstance(jstate.opt_state[0], optax.ScaleByAdamState)
  # resume in the port: weights and Adam moments carried across
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  tstate = ttrain.create_train_state(tm)
  convert.adam_state_from_optax(tstate.optimizer, tm, adam)
  count, mu, nu = convert.adam_state_to_optax(tstate.optimizer, tm)
  assert count == int(adam.count) == 2
  for a, b in zip(jax.tree.leaves((mu, nu)), jax.tree.leaves(
      (adam.mu, adam.nu))):
    np.testing.assert_array_equal(a, b)
  tstep, _ = ttrain.make_train_step(tm, C)
  for jb, tb in pairs[2:4]:            # two more steps in each
    jstate, jloss, _ = jstep(jstate, jtrain.batch_to_dict(jb))
    tstate, tloss, _ = tstep(tstate, ttrain.batch_to_dict(tb))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  _assert_params_close(tm, jstate.params)
  count, mu, _ = convert.adam_state_to_optax(tstate.optimizer, tm)
  assert count == int(jstate.opt_state[0].count) == 4
  for a, b in zip(jax.tree.leaves(mu),
                  jax.tree.leaves(jstate.opt_state[0].mu)):
    np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_products_example_runs_on_the_cpu():
  proc = subprocess.run(
      [sys.executable, '-m', 'graphlearn_tpu_torch.examples.train_sage_products',
       '--num-nodes', '3000', '--epochs', '1', '--device', 'cpu',
       '--batch-size', '64', '--eval-batches', '2'],
      cwd=ROOT, capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr[-3000:]
  out = json.loads(proc.stdout.strip().splitlines()[-1])
  assert out['steps_per_epoch'] == 3000 * 8 // 100 // 64
  assert np.isfinite(out['final_train_loss'])
  assert 0.0 <= out['test_acc'] <= 1.0 and out['test_seeds_evaluated'] > 0


@pytest.mark.parametrize('foreach', [False, True])
def test_capturable_adam_matches_optax(monkeypatch, foreach):
  """The Adam a CUDA graph replays (``capturable=True``: the step count
  and the bias corrections in tensors beside the parameters), held to
  optax.adam over 5 steps. Torch runs the capturable update only on an
  accelerator's tensors, so the test lets it take CPU tensors: the same
  tensor code as on the card."""
  from torch.optim import adam as torch_adam
  devices = torch_adam._get_capturable_supported_devices
  monkeypatch.setattr(torch_adam, '_get_capturable_supported_devices',
                      lambda *a, **k: devices(*a, **k) + ['cpu'])
  jl, tl, jm, tm = _pair('merge')
  pairs = list(zip(jl, tl))
  pairs = pairs + pairs[:5 - len(pairs)]
  jd0 = jtrain.batch_to_dict(pairs[0][0])
  params = _init(jm, tm, jd0)
  jstate, tx = jtrain.create_train_state(jm, jax.random.PRNGKey(0), jd0,
                                         lr=3e-3)
  jstate = jstate._replace(params=params, opt_state=tx.init(params))
  jstep, _ = jtrain.make_train_step(jm, tx, C)
  tstate = ttrain.create_train_state(tm, optimizer=torch.optim.Adam(
      tm.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
      capturable=True, foreach=foreach))
  tstep, _ = ttrain.make_train_step(tm, C)
  for jb, tb in pairs:
    jstate, jloss, _ = jstep(jstate, jtrain.batch_to_dict(jb))
    tstate, tloss, _ = tstep(tstate, ttrain.batch_to_dict(tb))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  assert tstate.step == int(jstate.step) == 5
  _assert_params_close(tm, jstate.params)
  steps = {float(st['step']) for st in tstate.optimizer.state.values()}
  assert steps == {5.0}
  count, mu, _ = convert.adam_state_to_optax(tstate.optimizer, tm)
  assert count == 5
  for a, b in zip(jax.tree.leaves(mu),
                  jax.tree.leaves(jstate.opt_state[0].mu)):
    np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_create_train_state_is_capturable_only_on_a_card():
  _, _, _, tm = _pair('tree')
  assert not ttrain.create_train_state(tm).optimizer.param_groups[0][
      'capturable']
