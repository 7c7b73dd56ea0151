"""The unsupervised example's steps one by one, from the JAX example's own
state at each step start, on the CPU.

The JAX example (``examples/graph_sage_unsup.py``, run as it is) records,
for every step, its batch, its parameters and Adam state before the step,
its loss and its parameters after. The port's example then runs the same
epoch; before each of its steps the port takes up JAX's parameters and
Adam state of that step (``models.convert``), and after it the step's
batch, loss and updated parameters are held to JAX's: the batch exact,
the loss within rtol 1e-4, every parameter within rtol 1e-4 of JAX's (atol
1e-6: an Adam step moves a weight near 0 by up to the rate).

Held so, a fault in any one step shows at that step; what is left over a
free-running epoch is the two stacks' rounding, which Adam carries on.

Run the whole epoch at the example's ``--avg-deg 3`` (~170 steps):
``JAX_PLATFORMS=cpu python tests/test_torch_link_steps.py``.
"""
import argparse
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.examples import graph_sage_unsup as example
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


def jax_steps(monkeypatch, argv, max_steps=None):
  """The JAX example's ``main`` as it is; per step (up to ``max_steps``):
  the batch dict, the parameters and optax Adam state before the step,
  the loss and the parameters after (numpy)."""
  spec = importlib.util.spec_from_file_location(
      'jax_graph_sage_unsup', ROOT / 'examples' / 'graph_sage_unsup.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  steps = []
  make_step = jtrain.make_link_train_step

  def make_recording_step(*a, **kw):
    step, eval_step = make_step(*a, **kw)

    def recording_step(state, batch):
      if max_steps is not None and len(steps) >= max_steps:
        return state, jax.numpy.zeros(()), jax.numpy.zeros(())
      out = step(state, batch)
      steps.append(dict(
          batch=jax.tree.map(np.asarray, batch),
          params=jax.tree.map(np.asarray, state.params),
          adam=jax.tree.map(np.asarray, tuple(state.opt_state[0])),
          loss=float(out[1]),
          after=jax.tree.map(np.asarray, out[0].params)))
      return out

    return recording_step, eval_step

  monkeypatch.setattr(jtrain, 'make_link_train_step', make_recording_step)
  monkeypatch.setattr(mod.glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  monkeypatch.setattr(sys, 'argv', ['graph_sage_unsup.py'] + argv)
  mod.main()
  return steps


def port_steps_from_jax_state(monkeypatch, args, steps):
  """The port's example over the same epoch, each step started from
  JAX's state of that step. Returns per step ``(batch equal, loss rel
  diff, worst param name, its max abs diff, params within tolerance)``."""
  readings = []
  make_step = ttrain.make_link_train_step

  def make_held_step(model):
    step, eval_step = make_step(model)

    def held_step(state, batch):
      i = len(readings)
      if i >= len(steps):
        return state, torch.zeros(()), torch.zeros(())
      rec = steps[i]
      model.load_state_dict(convert.params_from_flax(rec['params']))
      convert.adam_state_from_optax(state.optimizer, model, rec['adam'])
      same_batch = all(
          np.array_equal(np.asarray(batch[k]), rec['batch'][k])
          for k in ('x', 'edge_index', 'edge_mask', 'edge_label_index',
                    'edge_label'))
      state, loss, acc = step(state, batch)
      want = convert.params_from_flax(rec['after'])
      worst, worst_diff, ok = None, 0.0, True
      for name, p in model.state_dict().items():
        diff = float((p - want[name]).abs().max())
        ok &= bool(torch.allclose(p, want[name], rtol=PARAM_RTOL,
                                  atol=PARAM_ATOL))
        if diff >= worst_diff:
          worst, worst_diff = name, diff
      readings.append((same_batch,
                       abs(float(loss) - rec['loss']) / abs(rec['loss']),
                       worst, worst_diff, ok))
      return state, loss, acc

    return held_step, eval_step

  monkeypatch.setattr(ttrain, 'make_link_train_step', make_held_step)
  example.run(args, steps[0]['params'])
  return readings


def check_steps(monkeypatch, avg_deg, max_steps=None, num_nodes=2000,
                batch_size=64):
  argv = ['--epochs', '1', '--num-nodes', str(num_nodes), '--batch-size',
          str(batch_size), '--avg-deg', str(avg_deg)]
  steps = jax_steps(monkeypatch, argv, max_steps)
  args = argparse.Namespace(epochs=1, num_nodes=num_nodes, avg_deg=avg_deg,
                            batch_size=batch_size, hidden=128, lr=3e-3,
                            seed=0, device='cpu')
  readings = port_steps_from_jax_state(monkeypatch, args, steps)
  assert len(readings) == len(steps) > 0
  return readings


def test_example_steps_agree_from_the_jax_state(monkeypatch):
  """At ``--avg-deg 3``, the first 60 steps (past where a free-running
  epoch parts at ~100 steps, the whole epoch by the module's
  ``__main__``): every batch equal, every loss and update within
  tolerance from JAX's state."""
  readings = check_steps(monkeypatch, 3, max_steps=60)
  assert len(readings) == 60
  for i, (same, loss_rel, name, diff, ok) in enumerate(readings):
    assert same, f'step {i}: the batch differs from JAX\'s'
    assert loss_rel <= LOSS_RTOL, (i, loss_rel)
    assert ok, f'step {i}: {name} off by {diff}'


def main():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--avg-deg', type=int, default=3)
  ap.add_argument('--steps', type=int, default=None,
                  help='steps to hold (default: the whole epoch)')
  args = ap.parse_args()
  torch.set_num_threads(1)
  mp = pytest.MonkeyPatch()
  try:
    readings = check_steps(mp, args.avg_deg, args.steps)
  finally:
    mp.undo()
  worst_loss = max(r[1] for r in readings)
  worst_param = max(readings, key=lambda r: r[3])
  bad = [i for i, r in enumerate(readings)
         if not (r[0] and r[1] <= LOSS_RTOL and r[4])]
  print(f'{len(readings)} steps at --avg-deg {args.avg_deg}: batches equal '
        f'{sum(r[0] for r in readings)}/{len(readings)}; largest loss rel '
        f'diff {worst_loss:.3g} (rtol {LOSS_RTOL}); largest param abs diff '
        f'{worst_param[3]:.3g} ({worst_param[2]}); steps outside tolerance '
        f'{bad}')
  return 1 if bad else 0


if __name__ == '__main__':
  sys.exit(main())
