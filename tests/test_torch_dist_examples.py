"""The ported distributed examples against the JAX examples on the CPU:
``examples/distributed/dist_sage_unsup.py`` (distributed link
prediction) and ``examples/igbh/dist_train_rgnn.py`` (the typed RGNN over
shards), each at P = 2 and a small size.

The JAX example runs as it is (its mesh cut to 2 of the conftest's CPU
devices) and each call of its data-parallel step (the jitted
``shard_map`` of ``dp_step``) is recorded: the stacked batch it was
given, the parameters before it and its loss. The port's example then
runs the same epoch with each step held from JAX's parameters of that
step: the port's stacked batch equals JAX's exactly (the link batch with
its shard-local negatives and labels; the typed tree batch), and the
port's data-parallel loss (the package's step's loss function, averaged
over the shards) equals JAX's within rtol 1e-4 / atol 1e-5. The
synthetic data equal the JAX examples' array for array.
"""
import numpy as np
import torch

from test_torch_model_examples import load_jax_example

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def record_dp_steps(monkeypatch, mod, argv, nparts=2):
  """Run ``mod.main()`` with ``argv`` on ``nparts`` devices; per call of
  its ``dp_step`` program: the inputs after the optimizer state, the
  parameters before and the loss (numpy)."""
  import sys

  import jax

  import graphlearn_tpu as glt
  steps = []
  real_jit = jax.jit
  real_init = glt.distributed.init_worker_group

  def recording_jit(fn, *a, **kw):
    jfn = real_jit(fn, *a, **kw)
    if getattr(fn, '__name__', '') != 'dp_step':
      return jfn

    def step(params, opt_state, *inputs):
      out = jfn(params, opt_state, *inputs)
      steps.append(dict(
          params=jax.tree.map(np.asarray, params),
          inputs=jax.tree.map(np.asarray, inputs),
          loss=float(out[2])))
      return out

    return step

  monkeypatch.setattr(jax, 'jit', recording_jit)
  monkeypatch.setattr(glt.distributed, 'init_worker_group',
                      lambda **kw: real_init(**{**kw,
                                                'num_partitions': nparts}))
  monkeypatch.setattr(sys, 'argv', ['example.py'] + argv)
  mod.main()
  monkeypatch.setattr(jax, 'jit', real_jit)
  return steps


def _same(a, b):
  if isinstance(a, dict):
    return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
  b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
  return a.shape == b.shape and np.array_equal(a, b)


def held_run(monkeypatch, example, steps, args, loss_fn_of, order):
  """The port's example with each step held from JAX's parameters:
  ``[(batch equal, port loss, JAX loss)]``."""
  from graphlearn_tpu_torch.loader.pipeline import shard_batches
  from graphlearn_tpu_torch.models import convert
  readings = []

  def make_held(model, mesh):
    loss_fn = loss_fn_of(model)

    def step(state, batch):
      rec = steps[len(readings)]
      model.load_state_dict(convert.params_from_flax(rec['params'], model),
                            strict=False)
      stacked = example.fields(batch)
      same = all(_same(j, stacked[k]) for j, k in zip(rec['inputs'], order))
      with torch.no_grad():
        loss = torch.stack([loss_fn(b)[0] for b in shard_batches(stacked)
                            ]).mean()
      readings.append((same, float(loss), rec['loss']))
      return state._replace(step=state.step + 1), loss, loss

    return step

  monkeypatch.setattr(example, 'make_step', make_held)
  result, _ = example.run(args, steps[0]['params'])
  assert len(readings) == len(steps) > 0
  for i, (same, loss, jloss) in enumerate(readings):
    assert same, f'step {i}: the batch differs from JAX\'s'
    np.testing.assert_allclose(loss, jloss, err_msg=f'step {i}', **TOL)
  return result


SAGE_ARGV = ['--epochs', '1', '--num-nodes', '400', '--avg-deg', '4',
             '--batch-size', '64', '--fanout', '3', '2', '--hidden', '16',
             '--num-partitions', '2']


def test_dist_sage_unsup_data_match_jax():
  from graphlearn_tpu_torch.examples import dist_sage_unsup as example
  rng = np.random.default_rng(0)
  tr, te, feat = example.make_data(400, 4, rng)
  # the JAX example's draws, in its order
  rng = np.random.default_rng(0)
  n, e = 400, 1600
  comm = (np.arange(n) % 16).astype(np.int32)
  rows = rng.integers(0, n, e).astype(np.int32)
  intra = rng.random(e) < 0.85
  cols = np.where(intra, (rows + 16 * rng.integers(0, n // 16, e)) % n,
                  rng.integers(0, n, e)).astype(np.int32)
  want_feat = (comm[:, None] == np.arange(64) % 16).astype(np.float32) + \
      0.3 * rng.standard_normal((n, 64)).astype(np.float32)
  perm = rng.permutation(e)
  np.testing.assert_array_equal(feat, want_feat)
  np.testing.assert_array_equal(tr, np.stack([rows, cols])[:, perm[:1440]])
  np.testing.assert_array_equal(te, np.stack([rows, cols])[:, perm[1440:]])


def test_dist_sage_unsup_steps_agree_with_jax(monkeypatch):
  from graphlearn_tpu_torch.examples import dist_sage_unsup as example
  mod = load_jax_example('examples/distributed/dist_sage_unsup.py',
                         'jax_dist_sage_unsup')
  steps = record_dp_steps(monkeypatch, mod, SAGE_ARGV)
  assert len(steps) == 1440 // (2 * 64)
  args = example.parser().parse_args(SAGE_ARGV + ['--device', 'cpu'])
  result = held_run(monkeypatch, example, steps, args, example.loss_fn_for,
                    ('x', 'edge_index', 'edge_mask', 'eli', 'label'))
  assert set(result) == {'model', 'mesh_size', 'first_loss', 'final_loss',
                         'final_train_acc', 'test_link_acc', 'epoch_time_s'}
  assert 0.0 <= result['test_link_acc'] <= 1.0


RGNN_ARGV = ['--epochs', '1', '--n-paper', '2000', '--n-author', '1000',
             '--batch-size', '16', '--hidden', '16']


def test_dist_train_rgnn_steps_agree_with_jax(monkeypatch):
  from graphlearn_tpu_torch.examples import dist_train_rgnn as example
  from graphlearn_tpu_torch.models.train import make_loss_fn
  mod = load_jax_example('examples/igbh/dist_train_rgnn.py',
                         'jax_dist_train_rgnn')
  steps = record_dp_steps(monkeypatch, mod, RGNN_ARGV)
  assert len(steps) == 400 // (2 * 16)
  args = example.parser().parse_args(RGNN_ARGV + ['--device', 'cpu',
                                                  '--num-partitions', '2'])
  result = held_run(monkeypatch, example, steps, args,
                    lambda m: make_loss_fn(m, example.NUM_CLASSES),
                    ('x', 'edge_index', 'edge_mask', 'y', 'num_seed_nodes'))
  assert result['mesh_size'] == 2 and np.isfinite(result['first_loss'])
