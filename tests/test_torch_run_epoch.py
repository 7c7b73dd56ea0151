"""The port's RunTrainer against E of its own ScanTrainer epochs and
against the JAX package's RunTrainer.

Mirrors ``tests/test_run_epoch.py`` at its size: 96 nodes, 6 features, 3
classes, fanouts [3, 2], 44 seeds at batch 8 (6 steps, the last ragged)
in chunks of 4, so chunks cross the epoch boundaries and each epoch ends
in a tail. On the CPU the run is bit-identical to E ScanTrainer epochs
(shuffle on and off), with and without the eval counts, and with a
patience that never fires (the masked step changes nothing); against
the JAX RunTrainer the losses agree within atol 1e-5, rtol 1e-4 and the
run report is the same. An early stop zeroes the stopped tail and leaves
the parameters and Adam's tensors as they were at the stop, bit for bit;
a crash across an epoch boundary resumes bit-identically, the eval
carry included.
"""
import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.recovery import ChunkCheckpointer

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 96, 6, 3
FANOUTS = [3, 2]
BS = 8
STEPS = 6       # 44 seeds at batch 8: 5 full batches and a ragged tail
K = 4           # chunks of 4 cross the epoch boundaries at 6, 12, ...
TOL = dict(atol=1e-5, rtol=1e-4)


def _graph(seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _pool(num=44):
  return np.random.default_rng(9).permutation(N)[:num].astype(np.int64)


def _loader(**kw):
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', BS)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return gtt.loader.NeighborLoader(ds, FANOUTS, _pool(), device='cpu', **kw)


def _jax_loader(**kw):
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', BS)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return glt.loader.NeighborLoader(ds, FANOUTS, _pool(), **kw)


def _model(seed=0):
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def _run(model_seed=0, shuffle=False, **kw):
  model = _model(model_seed)
  trainer = gtt.loader.RunTrainer(_loader(shuffle=shuffle), model, C,
                                  chunk_size=K, **kw)
  return trainer, ttrain.create_train_state(model)


def _params(model):
  return [p.detach().clone() for p in model.parameters()]


def _adam(state):
  return [v.clone() for p in state.optimizer.param_groups[0]['params']
          for v in state.optimizer.state[p].values()]


def _equal(a, b):
  return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _scan_epochs(epochs, shuffle):
  """E sequential ScanTrainer epochs from the same start."""
  model = _model()
  ref = gtt.loader.ScanTrainer(_loader(shuffle=shuffle), model, C,
                               chunk_size=K)
  state = ttrain.create_train_state(model)
  losses, accs = [], []
  for _ in range(epochs):
    state, lo, ac = ref.run_epoch(state)
    losses.append(lo)
    accs.append(ac)
  return ref, state, torch.cat(losses), torch.cat(accs)


@pytest.mark.parametrize('shuffle', [False, True])
def test_run_trainer_bit_identical_to_scan_epochs(shuffle):
  """Three epochs as one run (18 steps in chunks of 4: boundaries inside
  chunks, a tail chunk of 2): the seed matrix is three ScanTrainer
  prologues', and losses, accuracies, parameters, the sampler's counter
  and the epoch index equal three ScanTrainer epochs' bit for bit; the
  report covers every epoch."""
  epochs = 3
  ref, ref_state, ref_losses, ref_accs = _scan_epochs(epochs, shuffle)
  trainer, state = _run(shuffle=shuffle, epochs=epochs)
  trainer._seeds_dev = ref._seeds_dev
  mat, mask = trainer._prologue(epochs * STEPS)
  for e in range(epochs):
    want = ref._epoch_seeds(gtt.random.fold_in(ref._perm_key, e), STEPS)
    assert torch.equal(mat[e * STEPS:(e + 1) * STEPS], want[0])
    assert torch.equal(mask[e * STEPS:(e + 1) * STEPS], want[1])
  state, losses, accs = trainer.run(state)
  assert losses.shape == (epochs * STEPS,) and state.step == epochs * STEPS
  assert torch.equal(losses, ref_losses) and torch.equal(accs, ref_accs)
  assert _equal(_params(trainer.model), _params(ref.model))
  assert _equal(_adam(state), _adam(ref_state))
  assert trainer._sampler._call_count == ref._sampler._call_count
  assert trainer._epochs == ref._epochs == epochs
  rep = trainer.last_run_report
  assert int(rep['epochs_run']) == epochs and not bool(rep['stopped'])
  assert bool(torch.isfinite(rep['eval_metric']).all())


@pytest.mark.parametrize('kw', [dict(track_eval=False), dict(patience=100)])
def test_run_trainer_modes_bit_identical(kw):
  """Without the eval counts, and with a patience that never fires (every
  step masked by a false stop flag), the run stays bit-identical."""
  _, _, ref_losses, _ = _scan_epochs(2, False)
  trainer, state = _run(epochs=2, **kw)
  state, losses, _ = trainer.run(state)
  assert torch.equal(losses, ref_losses)
  rep = trainer.last_run_report
  assert int(rep['epochs_run']) == 2 and not bool(rep['stopped'])
  assert bool(torch.isnan(rep['eval_metric']).all()) == \
      (not trainer.track_eval)


def _jax_run(**kw):
  model = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(_jax_loader())))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0), first)
  shuffle = kw.pop('shuffle', False)
  return glt.RunTrainer(_jax_loader(shuffle=shuffle), model, tx, C,
                        chunk_size=K, **kw), state


@pytest.mark.parametrize('shuffle', [False, True])
def test_run_trainer_matches_jax(shuffle):
  """The same run in each package from the same weights: losses,
  accuracies and parameters within atol 1e-5, rtol 1e-4, and the run
  report (per-epoch metric, best, epochs run, stop) alike."""
  jt, jstate = _jax_run(shuffle=shuffle, epochs=2)
  trainer, state = _run(shuffle=shuffle, epochs=2)
  trainer.model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  jstate, jlosses, jaccs = jt.run(jstate)
  state, losses, accs = trainer.run(state)
  np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
  np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in trainer.model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)
  _assert_report_matches(trainer.last_run_report, jt.last_run_report)


def _assert_report_matches(rep, jrep):
  jrep = jax.device_get(jrep)
  np.testing.assert_allclose(rep['eval_metric'].numpy(),
                             jrep['eval_metric'], **TOL)
  np.testing.assert_allclose(float(rep['best_metric']),
                             float(jrep['best_metric']), **TOL)
  assert int(rep['epochs_run']) == int(jrep['epochs_run'])
  assert bool(rep['stopped']) == bool(jrep['stopped'])


def test_early_stop_masks_the_stopped_steps():
  """patience=1 and min_delta=10 stop the run after epoch 2: the stopped
  tail's losses and accuracies are 0, the parameters and Adam's tensors
  taken at the step-12 boundary are the final ones bit for bit, the
  report equals the JAX run's, and the sampler's counter still advanced
  by the scheduled steps."""
  epochs = 5
  jt, jstate = _jax_run(epochs=epochs, patience=1, min_delta=10.0)
  trainer, state = _run(epochs=epochs, patience=1, min_delta=10.0)
  trainer.model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  at_stop = {}

  def grab(c, start, k):
    if start + k == 2 * STEPS:
      st = trainer._chunk_carry['state']
      at_stop.update(params=_params(trainer.model), adam=_adam(st),
                     ev={n: t.clone() for n, t in
                         trainer._chunk_carry['eval'].items()})

  trainer.ack_hook = grab
  jstate, jlosses, _ = jt.run(jstate)
  state, losses, accs = trainer.run(state)
  total = epochs * STEPS
  assert losses.shape == (total,)
  assert bool((losses[:2 * STEPS] != 0).all())
  assert bool((losses[2 * STEPS:] == 0).all())
  assert bool((accs[2 * STEPS:] == 0).all())
  np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
  assert _equal(_params(trainer.model), at_stop['params'])
  assert _equal(_adam(state), at_stop['adam'])
  for n, t in at_stop['ev'].items():   # NaN for the epochs never reached
    torch.testing.assert_close(trainer._ev[n], t, rtol=0, atol=0,
                               equal_nan=True)
  rep = trainer.last_run_report
  assert bool(rep['stopped']) and int(rep['epochs_run']) == 2
  assert bool(torch.isnan(rep['eval_metric'][2:]).all())
  _assert_report_matches(rep, jt.last_run_report)
  assert trainer._sampler._call_count == total
  assert trainer._epochs == epochs


def test_crash_resume_across_epoch_boundary(tmp_path):
  """A run that crashes after its second chunk (step 8, inside epoch 2)
  resumes in a fresh trainer bit-identically: losses, parameters and the
  run report, the eval carry restored from the snapshot."""
  epochs = 3
  ref, ref_state = _run(shuffle=True, epochs=epochs)
  ref_state, ref_losses, ref_accs = ref.run(ref_state)
  victim, state = _run(shuffle=True, epochs=epochs)
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(victim)
  inner = victim.ack_hook

  def killer(c, start, k):
    inner(c, start, k)
    if c == 1:
      raise RuntimeError('injected crash')

  victim.ack_hook = killer
  with pytest.raises(RuntimeError, match='injected'):
    victim.run(state)
  ck.close()
  ck.detach()
  snap = ChunkCheckpointer(str(tmp_path)).latest()
  assert snap.next_start == 8 and int(snap.arrays['extra:eval:edone']) == 1
  fresh, template = _run(model_seed=4, shuffle=True, epochs=epochs)
  state, losses, accs = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  np.testing.assert_array_equal(losses, ref_losses.numpy())
  np.testing.assert_array_equal(accs, ref_accs.numpy())
  assert _equal(_params(fresh.model), _params(ref.model))
  for key, val in ref.last_run_report.items():
    torch.testing.assert_close(fresh.last_run_report[key], val, rtol=0,
                               atol=0, equal_nan=True)
  assert fresh._epochs == epochs
  assert fresh._sampler._call_count == ref._sampler._call_count


def test_run_trainer_validation():
  model = _model()
  with pytest.raises(ValueError, match='epochs'):
    gtt.loader.RunTrainer(_loader(), model, C, epochs=0)
  with pytest.raises(ValueError, match='patience'):
    gtt.loader.RunTrainer(_loader(), model, C, epochs=2, patience=0)
  with pytest.raises(ValueError, match='track_eval'):
    gtt.loader.RunTrainer(_loader(), model, C, epochs=2, patience=1,
                          track_eval=False)
  with pytest.raises(ValueError, match='chunk boundary'):
    trainer, state = _run(epochs=2)
    trainer.run(state, start_step=3)
