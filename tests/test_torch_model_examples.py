"""The ported HGT, gate and SEAL examples against the JAX examples, on the
CPU, at tiny sizes.

The JAX examples run as they are. A step of theirs (the ``step``
function their ``main`` jits) is recorded call by call: its batch, its
parameters and optax state before the step, its loss and gradients
(from the ``loss_fn`` the step closes over) and its parameters after.
The port's example then runs the same epoch, and before each of its
steps takes up JAX's parameters and Adam state of that step
(``models.convert``): the batch is held exact, the loss within rtol 1e-4,
the gradients within atol 1e-5 / rtol 2e-4, and Adam on JAX's gradients
must give JAX's parameters after the step (rtol 1e-4, atol 1e-6). (An
HGT's key biases get gradients at rounding level, 0 in exact arithmetic,
and Adam scales such noise up to a step of its own; so the update is
held on common gradients.) As tests/test_torch_link_steps.py holds the
unsupervised example (C7).

The gate example's synthetic graph equals the JAX example's array for
array, and the gate runs in every conv and mode.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def load_jax_example(rel, name):
  spec = importlib.util.spec_from_file_location(name, ROOT / rel)
  mod = importlib.util.module_from_spec(spec)
  sys.path.insert(0, str((ROOT / rel).parent))
  try:
    spec.loader.exec_module(mod)
  finally:
    sys.path.remove(str((ROOT / rel).parent))
  return mod


def record_jax_steps(monkeypatch, mod, argv, aux):
  """Run ``mod.main()`` with ``argv``; per call of the ``step`` its main
  jits: the batch, parameters and optax state before, loss, gradients
  and parameters after (numpy). ``aux``: the loss_fn returns ``(loss,
  aux)``."""
  import graphlearn_tpu as glt
  steps = []
  real_jit = jax.jit

  def recording_jit(fn, *a, **kw):
    jfn = real_jit(fn, *a, **kw)
    if getattr(fn, '__qualname__', '') != 'main.<locals>.step':
      return jfn
    closure = dict(zip(fn.__code__.co_freevars,
                       (c.cell_contents for c in fn.__closure__)))
    loss_fn = closure['loss_fn']
    grad_fn = real_jit(jax.value_and_grad(loss_fn, has_aux=aux))

    def step(params, opt_state, batch):
      val, grads = grad_fn(params, batch)
      out = jfn(params, opt_state, batch)
      steps.append(dict(
          batch=jax.tree.map(np.asarray, batch),
          params=jax.tree.map(np.asarray, params),
          adam=jax.tree.map(np.asarray, tuple(opt_state[0])),
          loss=float(val[0] if aux else val),
          grads=jax.tree.map(np.asarray, grads),
          after=jax.tree.map(np.asarray, out[0])))
      return out

    return step

  monkeypatch.setattr(jax, 'jit', recording_jit)
  monkeypatch.setattr(glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  monkeypatch.setattr(sys, 'argv', ['example.py'] + argv)
  mod.main()
  monkeypatch.setattr(jax, 'jit', real_jit)
  return steps


def held_step(model, optimizer, rec, loss_of, batch_equal):
  """One port step from JAX's state ``rec``; returns its readings."""
  model.load_state_dict(convert.params_from_flax(rec['params'], model))
  convert.adam_state_from_optax(optimizer, model, rec['adam'])
  same = batch_equal(rec['batch'])
  optimizer.zero_grad()
  loss = loss_of()
  loss.backward()
  jg = convert.params_from_flax(rec['grads'], model)
  bad_grads = [n for n, p in model.named_parameters() if not torch.allclose(
      p.grad if p.grad is not None else torch.zeros_like(p), jg[n],
      rtol=GRAD_RTOL, atol=GRAD_ATOL)]
  for n, p in model.named_parameters():
    p.grad = jg[n].clone()
  optimizer.step()
  want = convert.params_from_flax(rec['after'], model)
  bad_params = [n for n, p in model.named_parameters() if not torch.allclose(
      p.detach(), want[n], rtol=PARAM_RTOL, atol=PARAM_ATOL)]
  return dict(same=same, loss=float(loss.detach()), jax_loss=rec['loss'],
              bad_grads=bad_grads, bad_params=bad_params)


def check_readings(readings, n):
  assert len(readings) == n > 0
  for i, r in enumerate(readings):
    assert r['same'], f'step {i}: the batch differs from JAX\'s'
    assert abs(r['loss'] - r['jax_loss']) <= LOSS_RTOL * abs(r['jax_loss']), \
        (i, r)
    assert not r['bad_grads'], (i, r)
    assert not r['bad_params'], (i, r)


def _eq(a, b):
  if isinstance(b, dict):
    return set(a) == set(b) and all(_eq(a[k], b[k]) for k in b)
  return np.array_equal(np.asarray(a), np.asarray(b))


def test_hgt_mag_example_steps_agree_from_the_jax_state(monkeypatch):
  """examples/hetero/train_hgt_mag.py against its port: one epoch of 12
  steps (2,000 papers, batch 32, hidden 16, 2 heads), every step held
  from JAX's state."""
  from graphlearn_tpu_torch.examples import train_hgt_mag as example
  argv = ['--epochs', '1', '--n-paper', '2000', '--batch-size', '32',
          '--hidden', '16', '--heads', '2']
  mod = load_jax_example('examples/hetero/train_hgt_mag.py',
                         'jax_train_hgt_mag')
  steps = record_jax_steps(monkeypatch, mod, argv, aux=True)
  readings = []
  make_step = ttrain.make_train_step

  def make_held(model, num_classes):
    _, eval_step = make_step(model, num_classes)
    loss_fn = ttrain.make_loss_fn(model, num_classes)

    def step(state, batch):
      rec = steps[len(readings)]

      def batch_equal(jb):
        return all(_eq({k: v.numpy() for k, v in batch[t].items()}, jb[j])
                   for t, j in (('x', 'x'), ('edge_index', 'ei'),
                                ('edge_mask', 'em'))) and \
            _eq(batch['y'].numpy(), jb['y']) and \
            int(batch['num_seed_nodes']) == int(jb['num_seed'])

      readings.append(held_step(model, state.optimizer, rec,
                                lambda: loss_fn(batch)[0], batch_equal))
      return state._replace(step=state.step + 1), torch.zeros(()), \
          torch.zeros(())

    return step, eval_step

  monkeypatch.setattr(ttrain, 'make_train_step', make_held)
  args = argparse.Namespace(epochs=1, n_paper=2000, batch_size=32,
                            hidden=16, heads=2, lr=3e-3, seed=0,
                            device='cpu')
  example.run(args, steps[0]['params'])
  check_readings(readings, 12)


def test_seal_example_steps_agree_from_the_jax_state(monkeypatch):
  """examples/seal_link_pred.py against its port: the extraction (DRNL
  labels, padding, link order) gives JAX's batches bit for bit, and each
  of the epoch's 6 DGCNN steps, held from JAX's state, gives JAX's loss,
  gradients and update."""
  from graphlearn_tpu_torch.examples import seal_link_pred as example
  argv = ['--epochs', '1', '--num-nodes', '400', '--num-links', '48',
          '--batch-size', '16']
  mod = load_jax_example('examples/seal_link_pred.py', 'jax_seal_link_pred')
  steps = record_jax_steps(monkeypatch, mod, argv, aux=False)
  readings = []

  def make_held(model, optimizer):
    import torch.nn.functional as F

    def step(batch):
      def loss_of():
        logits = model(batch['z'], batch['ei'], batch['em'], batch['nm'])
        return F.binary_cross_entropy_with_logits(logits,
                                                  batch['y'].float())

      readings.append(held_step(
          model, optimizer, steps[len(readings)], loss_of,
          lambda jb: _eq({k: v.numpy() for k, v in batch.items()}, jb)))
      return torch.zeros(())

    return step

  monkeypatch.setattr(example, 'make_step', make_held)
  args = example.parser().parse_args(argv + ['--device', 'cpu'])
  example.run(args, steps[0]['params'])
  check_readings(readings, 6)


def test_dgcnn_forward_matches_flax():
  """The DGCNN on one padded batch from the port's extraction: logits
  equal flax's (the JAX example's module, captured from its
  ``nn.vmap``) with the parameters carried across."""
  from graphlearn_tpu_torch.examples import seal_link_pred as example
  import flax.linen as nn
  captured = []
  real_vmap = nn.vmap

  class Captured(Exception):
    pass

  def capture(target, **kw):
    captured.append((target, kw))
    raise Captured

  mod = load_jax_example('examples/seal_link_pred.py', 'jax_seal_capture')
  args = example.parser().parse_args(
      ['--num-nodes', '300', '--num-links', '8', '--device', 'cpu'])
  mp = pytest.MonkeyPatch()
  try:
    mp.setattr(nn, 'vmap', capture)
    mp.setattr(sys, 'argv', ['seal.py', '--num-nodes', '300',
                             '--num-links', '8'])
    with pytest.raises(Captured):
      mod.main()
  finally:
    mp.undo()
  target, kw = captured[0]
  jm = real_vmap(target, **kw)(k=args.sortpool_k)
  graph_ei, pos, neg, _, _ = example.make_graph(args)
  import graphlearn_tpu_torch as gtt
  sampler = gtt.sampler.NeighborSampler(
      gtt.data.Graph(gtt.data.Topology(graph_ei, num_nodes=300), mode='CPU',
                     device='cpu'), args.fanout, seed=0, device='cpu')
  data = [np.concatenate(p) for p in zip(
      example.extract(sampler, pos, 1, args),
      example.extract(sampler, neg, 0, args))]
  z, ei, em, nm, _ = data
  params = jax.tree.map(np.asarray,
                        jm.init(jax.random.PRNGKey(0), z, ei, em, nm))
  want = np.asarray(jm.apply(params, z, ei, em, nm))
  tm = example.DGCNN(k=args.sortpool_k, device='cpu')
  sd = convert.params_from_flax(params, tm)
  assert set(sd) == set(tm.state_dict())
  tm.load_state_dict(sd)
  with torch.no_grad():
    got = tm(*(torch.as_tensor(a) for a in (z, ei, em, nm)))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
  back = convert.params_to_flax(sd, tm)
  for (pa, a), (pb, b) in zip(
      jax.tree_util.tree_flatten_with_path(params)[0],
      jax.tree_util.tree_flatten_with_path(back)[0]):
    assert pa == pb
    np.testing.assert_array_equal(a, b)


GATE_ARGV = ['--n-paper', '3000', '--n-author', '1500', '--batch-size', '64',
             '--fanout', '5', '3', '--epochs', '1', '--hidden', '16',
             '--heads', '2', '--eval-batches', '3', '--device', 'cpu']


def test_gate_synthetic_matches_jax():
  """The gate example's typed synthetic equals the JAX example's, array
  for array (the same numpy stream, the products gate's power-law
  targets)."""
  from graphlearn_tpu_torch.examples import train_rgnn_gate as example
  mod = load_jax_example('examples/igbh/train_rgnn_gate.py', 'jax_gate')
  args = (3000, 1500, 8, 16, 0.6, 0.1, 12, 6)
  want = mod.make_synthetic(*args, np.random.default_rng(0))
  got = example.make_synthetic(*args, np.random.default_rng(0))
  assert len(got) == len(want)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('conv', ['sage', 'gat', 'hgt'])
@pytest.mark.parametrize('mode', ['segment', 'tree_dense', 'merge_dense'])
def test_gate_example_runs(conv, mode, capsys):
  """The gate example in every conv and mode (and bf16 once): one epoch,
  finite losses, the JAX example's JSON keys."""
  from graphlearn_tpu_torch.examples import train_rgnn_gate as example
  extra = ['--bf16-model'] if (conv, mode) == ('hgt', 'merge_dense') else []
  result = example.main(GATE_ARGV + ['--conv', conv, '--mode', mode] + extra)
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line == json.loads(json.dumps(result))
  assert set(line) == {'conv', 'mode', 'epochs', 'steps_per_epoch',
                       'epoch_time_s', 'first_train_loss',
                       'final_train_loss', 'test_acc', 'test_acc_at',
                       'timing'}
  assert line['steps_per_epoch'] == 14
  assert np.isfinite([line['first_train_loss'], line['final_train_loss']]).all()
  assert 0.0 <= line['test_acc'] <= 1.0
