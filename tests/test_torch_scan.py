"""The port's ScanTrainer against its per-step loop and the JAX trainer.

Mirrors ``tests/test_scan_epoch.py``: with shuffle=False a scanned epoch
replays the per-step loader loop exactly (a ragged tail batch and a tail
chunk: 44 seeds at batch 8, K = 4), and a second epoch continues the
sampler's stream; with shuffle=True the seed matrix is bit-equal to the
JAX ScanTrainer's (the permutation is ``random.permutation``), and the
losses agree with the JAX trainer's within atol=1e-5, rtol=1e-4;
drop_last scans the permutation's prefix; the calibrated-caps overflow
guard raises at epoch end.
"""
import copy

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

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 96, 6, 3
TOL = dict(atol=1e-5, rtol=1e-4)


def _graph(seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _pool(num_seeds):
  # a pool whose first id is not 0: a tail padded otherwise than with
  # node id 0 would show
  return np.random.default_rng(9).permutation(N)[:num_seeds].astype(np.int64)


def _port_loader(num_seeds, **kw):
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', 8)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return gtt.loader.NeighborLoader(ds, [3, 2], _pool(num_seeds),
                                   device='cpu', **kw)


def _jax_loader(num_seeds, **kw):
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', 8)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return glt.loader.NeighborLoader(ds, [3, 2], _pool(num_seeds), **kw)


def _model(seed=0):
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def test_scan_trainer_matches_per_step_loop():
  loop_loader = _port_loader(44)
  ref_model = _model()
  model = copy.deepcopy(ref_model)
  ref_state = ttrain.create_train_state(ref_model)
  step, _ = ttrain.make_train_step(ref_model, C)
  ref_losses = []
  for b in loop_loader:
    ref_state, loss, _ = step(ref_state, ttrain.batch_to_dict(b))
    ref_losses.append(loss)
  assert len(ref_losses) == 6          # 5 full batches + the ragged tail

  trainer = gtt.loader.ScanTrainer(_port_loader(44), model, C, chunk_size=4)
  state = ttrain.create_train_state(model)
  state, losses, accs = trainer.run_epoch(state)
  assert losses.shape == accs.shape == (6,) and state.step == 6
  assert torch.equal(losses, torch.stack(ref_losses))
  for a, b in zip(ref_model.parameters(), model.parameters()):
    assert torch.equal(a, b)
  assert trainer.loader.sampler._call_count == loop_loader.sampler._call_count
  # a second epoch of both continues the same stream
  for b in loop_loader:
    ref_state, loss, _ = step(ref_state, ttrain.batch_to_dict(b))
  state, losses2, _ = trainer.run_epoch(state)
  assert losses2.shape == (6,) and loss == losses2[-1]
  for a, b in zip(ref_model.parameters(), model.parameters()):
    assert torch.equal(a, b)


def _jax_trainer(num_seeds, chunk, **kw):
  loader = _jax_loader(num_seeds, **kw)
  model = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(_jax_loader(num_seeds, **kw))))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0), first)
  return glt.loader.ScanTrainer(loader, model, tx, C, chunk_size=chunk), \
      state


def test_shuffled_seed_matrix_and_losses_match_jax():
  jtrainer, jstate = _jax_trainer(44, 4, shuffle=True)
  params = jax.tree.map(np.asarray, jstate.params)
  model = _model()
  model.load_state_dict(convert.params_from_flax(params))
  trainer = gtt.loader.ScanTrainer(_port_loader(44, shuffle=True), model, C,
                                   chunk_size=4)
  trainer._seeds_dev = torch.as_tensor(_pool(44).astype(np.int32))
  seeds_dev = jax.numpy.asarray(_pool(44).astype(np.int32))
  for epoch in (0, 1):
    jmat, jmask = jtrainer._seed_fn(
        seeds_dev, jax.random.fold_in(jtrainer._perm_key, epoch), 6)
    tmat, tmask = trainer._epoch_seeds(
        gtt.random.fold_in(trainer._perm_key, epoch), 6)
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
  state = ttrain.create_train_state(model)
  for _ in range(2):
    jstate, jlosses, jaccs = jtrainer.run_epoch(jstate)
    state, losses, accs = trainer.run_epoch(state)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)


def test_scan_trainer_drop_last_and_shuffle():
  model = _model()
  trainer = gtt.loader.ScanTrainer(
      _port_loader(44, shuffle=True, drop_last=True), model, C,
      chunk_size=3)
  state = ttrain.create_train_state(model)
  state, losses, accs = trainer.run_epoch(state)
  assert losses.shape == (5,) and bool(torch.isfinite(losses).all())
  mat, mask = trainer._epoch_seeds(
      gtt.random.fold_in(trainer._perm_key, 0), 5)
  assert mat.shape == (5, 8) and bool(mask.all())
  # the prefix of one permutation: 40 distinct seeds of the pool
  assert len(set(mat.reshape(-1).tolist())) == 40
  assert set(mat.reshape(-1).tolist()) <= set(_pool(44).tolist())
  mat2, _ = trainer._epoch_seeds(gtt.random.fold_in(trainer._perm_key, 1), 5)
  assert not torch.equal(mat, mat2)    # the epoch folds into the key
  assert trainer._epochs == 1
  # max_steps truncates; the counter advances by the steps taken
  count = trainer.loader.sampler._call_count
  state, losses, _ = trainer.run_epoch(state, max_steps=2)
  assert losses.shape == (2,) and state.step == 7
  assert trainer.loader.sampler._call_count == count + 2


def test_scan_trainer_overflow_guard():
  def trainer_for(**kw):
    loader = _port_loader(32, dedup='merge', **kw)
    return gtt.loader.ScanTrainer(loader, _model(), C, chunk_size=4)

  tr = trainer_for(frontier_caps=[1, 1])
  state = ttrain.create_train_state(tr.model)
  with pytest.raises(RuntimeError, match='frontier_caps overflowed'):
    tr.run_epoch(state)
  assert tr._epochs == 1     # the epoch ran; its verdict raised

  tr = trainer_for(frontier_caps=[1, 1])
  state, _, _ = tr.run_epoch(ttrain.create_train_state(tr.model),
                             max_steps=2)
  assert tr.loader.check_overflow()

  tr = trainer_for(frontier_caps='auto')
  state, losses, _ = tr.run_epoch(ttrain.create_train_state(tr.model))
  assert losses.shape == (4,) and bool(torch.isfinite(losses).all())

  with pytest.raises(ValueError, match='recompute'):
    trainer_for(frontier_caps=[1, 1], overflow_policy='recompute')


class _HostKeyTrainer(gtt.loader.ScanTrainer):
  """The chunk with every step's key folded in and split on the host
  (``fold_in(base_key, count0 + g)`` from a Python int), the per-step
  path that device keys replace."""

  def _chunk(self, state, seeds, masks, base_key, counter):
    count = int(counter)
    losses, accs = [], []
    ovf = torch.zeros((), dtype=torch.bool)
    for j in range(seeds.shape[0]):
      key = gtt.random.fold_in(self._sampler._key, count + j)
      batch, overflow = self._sample_collate(
          seeds[j], masks[j], gtt.random.split(key, self._n_hops))
      _, loss, acc = self._train_step(state, batch)
      ovf = ovf | overflow
      losses.append(loss)
      accs.append(acc)
    return torch.stack(losses), torch.stack(accs), ovf, None


@pytest.mark.parametrize('chunk,max_steps', [
    (1, None), (3, None), (6, None), (4, None), (4, 5), (3, 2)])
def test_device_keys_bit_equal_to_host_keys(chunk, max_steps):
  """The trainer's chunk keys from ``ops.step_keys`` (a counter tensor)
  against the host path: seed matrices, losses, accuracies and the model
  bit-equal over two epochs, for chunks of 1 and 3, the whole epoch, a
  ragged tail (4 + 2) and ``max_steps`` truncation; the sampler's call
  count advances by the steps taken in both."""
  runs = []
  for cls in (gtt.loader.ScanTrainer, _HostKeyTrainer):
    model = _model()
    trainer = cls(_port_loader(44, shuffle=True), model, C, chunk_size=chunk)
    state = ttrain.create_train_state(model)
    out = []
    for _ in range(2):
      count = trainer.loader.sampler._call_count
      state, losses, accs = trainer.run_epoch(state, max_steps=max_steps)
      steps = losses.shape[0]
      assert steps == (6 if max_steps is None else max_steps)
      assert trainer.loader.sampler._call_count == count + steps
      out.append((losses, accs, trainer._epoch_seeds(
          gtt.random.fold_in(trainer._perm_key, trainer._epochs - 1), 6)))
    assert state.step == 2 * steps
    runs.append((out, [p.detach().clone() for p in model.parameters()]))
  (dev_out, dev_params), (host_out, host_params) = runs
  for (l1, a1, (m1, k1)), (l2, a2, (m2, k2)) in zip(dev_out, host_out):
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert torch.equal(m1, m2) and torch.equal(k1, k2)
  for a, b in zip(dev_params, host_params):
    assert torch.equal(a, b)


def test_capture_needs_a_card():
  model = _model()
  with pytest.raises(ValueError, match='CUDA device'):
    gtt.loader.ScanTrainer(_port_loader(16), model, C, capture=True)
  trainer = gtt.loader.ScanTrainer(_port_loader(16), model, C)
  assert not trainer.capture and trainer.capture_ms == {}


def test_replay_signature_tracks_what_a_graph_freezes():
  """What a captured chunk freezes of the train state: unchanged by the
  steps of an epoch; changed by a loaded Adam state (a deep copy, or
  optax's through ``convert``), a new rate and another optimizer, each of
  which makes a captured trainer warm up and capture again."""
  from graphlearn_tpu_torch.loader.scan_epoch import _replay_signature
  model = _model()
  trainer = gtt.loader.ScanTrainer(_port_loader(16), model, C, chunk_size=2)
  state = ttrain.create_train_state(model)
  fresh = _replay_signature(model, state.optimizer)
  state, _, _ = trainer.run_epoch(state)
  sig = _replay_signature(model, state.optimizer)
  assert sig != fresh           # the first step made Adam's state
  state, _, _ = trainer.run_epoch(state)
  opt = state.optimizer
  assert _replay_signature(model, opt) == sig
  opt.load_state_dict(copy.deepcopy(opt.state_dict()))
  loaded = _replay_signature(model, opt)
  assert loaded != sig
  opt.param_groups[0]['lr'] = 1e-3
  rate = _replay_signature(model, opt)
  assert rate != loaded
  convert.adam_state_from_optax(opt, model,
                                convert.adam_state_to_optax(opt, model))
  assert _replay_signature(model, opt) != rate
  other = ttrain.create_train_state(model).optimizer
  other.load_state_dict(opt.state_dict())
  assert _replay_signature(model, other) != _replay_signature(model, opt)


@pytest.mark.parametrize('kw', [dict(padded_window=4, dedup='tree'),
                                dict(strategy='block', dedup='merge'),
                                dict(node_budget=20, dedup='tree')])
def test_mode_scan_trainer_matches_jax(kw):
  """ScanTrainer epochs in the other sampling modes against the JAX
  ScanTrainer's, two shuffled epochs from the same weights: losses,
  accuracies and parameters within atol 1e-5, rtol 1e-4. Under the
  padded window the second epoch of both samples a reseeded table."""
  jtrainer, jstate = _jax_trainer(44, 4, shuffle=True, **kw)
  model = _model()
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  trainer = gtt.loader.ScanTrainer(_port_loader(44, shuffle=True, **kw),
                                   model, C, chunk_size=4)
  state = ttrain.create_train_state(model)
  for _ in range(2):
    jstate, jlosses, jaccs = jtrainer.run_epoch(jstate)
    state, losses, accs = trainer.run_epoch(state)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)
  assert trainer._sampler._call_count == jtrainer._sampler._call_count
  if 'padded_window' in kw:
    assert trainer._sampler._padded_seed == jtrainer._sampler._padded_seed \
        == 1
