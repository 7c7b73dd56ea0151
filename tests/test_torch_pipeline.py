"""The port's OverlappedTrainer against its per-step loader loop and the
JAX package's OverlappedTrainer.

Mirrors ``tests/test_loader.py``'s OverlappedTrainer tests at the size
of ``tests/test_run_epoch.py``: 96 nodes, 6 features, 3 classes, fanouts
[3, 2], 44 seeds at batch 8 (6 steps, the last ragged). Each batch takes
the sampler's next key in the loop's order, so on the CPU (where the
trainer runs its two halves in turn) the losses and parameters are the
loop's bit for bit, shuffle on and off, over two epochs; against the JAX
trainer they agree within atol 1e-5, rtol 1e-4. ``max_steps`` makes
exactly that many updates and drops the pending batch with its overflow
flag; the calibrated-caps guard raises at the epoch's end;
``overflow_policy='recompute'`` is refused.
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


def _pool(num=44):
  return np.random.default_rng(9).permutation(N)[:num].astype(np.int64)


def _loader(**kw):
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', 8)
  kw.setdefault('shuffle', False)
  kw.setdefault('seed', 0)
  return gtt.loader.NeighborLoader(ds, [3, 2], _pool(), device='cpu', **kw)


def _model(seed=0):
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def _loop(epochs, max_steps=None, **kw):
  """The per-step loop: loader -> batch_to_dict -> train_step."""
  loader, model = _loader(**kw), _model()
  state = ttrain.create_train_state(model)
  step, _ = ttrain.make_train_step(model, C)
  losses = []
  for _ in range(epochs):
    for b in loader:
      if max_steps is not None and len(losses) == max_steps:
        break
      state, loss, _ = step(state, ttrain.batch_to_dict(b))
      losses.append(loss)
  return loader, model, state, torch.stack(losses)


def _params(model):
  return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize('shuffle', [False, True])
def test_overlapped_matches_loop(shuffle):
  loop_loader, loop_model, _, want = _loop(2, shuffle=shuffle)
  model = _model()
  trainer = gtt.loader.OverlappedTrainer(_loader(shuffle=shuffle), model, C)
  state = ttrain.create_train_state(model)
  losses = []
  for _ in range(2):
    state, lo = trainer.run_epoch(state)
    assert len(lo) == 6
    losses += lo
  assert state.step == 12
  assert torch.equal(torch.stack(losses), want)
  for a, b in zip(_params(model), _params(loop_model)):
    assert torch.equal(a, b)
  assert trainer._sampler._call_count == loop_loader.sampler._call_count


def test_max_steps_makes_exactly_that_many_updates():
  """``max_steps=3``: three updates, the loop's first three; the fourth
  batch was sampled (its key taken, as in JAX) and dropped."""
  _, loop_model, _, want = _loop(1, max_steps=3)
  model = _model()
  trainer = gtt.loader.OverlappedTrainer(_loader(), model, C)
  state, losses = trainer.run_epoch(ttrain.create_train_state(model),
                                    max_steps=3)
  assert len(losses) == 3 and state.step == 3
  assert torch.equal(torch.stack(losses), want)
  for a, b in zip(_params(model), _params(loop_model)):
    assert torch.equal(a, b)
  assert trainer._sampler._call_count == 4


@pytest.mark.parametrize('shuffle', [False, True])
def test_overlapped_matches_jax(shuffle):
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  mk = lambda: glt.loader.NeighborLoader(  # noqa: E731
      ds, [3, 2], _pool(), batch_size=8, shuffle=shuffle, seed=0)
  jmodel = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(mk())))
  jstate, tx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0), first)
  model = _model()
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
  jt = glt.loader.OverlappedTrainer(mk(), jmodel, tx, C)
  trainer = gtt.loader.OverlappedTrainer(_loader(shuffle=shuffle), model, C)
  state = ttrain.create_train_state(model)
  jstate, jlosses = jt.run_epoch(jstate)
  state, losses = trainer.run_epoch(state)
  np.testing.assert_allclose(torch.stack(losses).numpy(),
                             np.asarray(jlosses), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)
  assert trainer._sampler._call_count == jt._sampler._call_count


def _guarded(caps, **kw):
  loader = _loader(dedup='merge', frontier_caps=caps, **kw)
  return gtt.loader.OverlappedTrainer(loader, _model(), C)


def test_overflow_guard_and_pending_flag():
  """The guard raises at the epoch's end; a ``max_steps`` break leaves the
  verdict to ``check_overflow()``, counting only the batches trained: a
  flag set on the pending (dropped) batch alone does not count."""
  tr = _guarded([1, 1])
  with pytest.raises(RuntimeError, match='frontier_caps overflowed'):
    tr.run_epoch(ttrain.create_train_state(tr.model))
  tr = _guarded([1, 1])
  tr.run_epoch(ttrain.create_train_state(tr.model), max_steps=1)
  assert tr.loader.check_overflow()
  tr = _guarded('auto')
  _, losses = tr.run_epoch(ttrain.create_train_state(tr.model))
  assert len(losses) == 6 and bool(torch.isfinite(torch.stack(losses)).all())

  for max_steps, flagged in ((1, False), (2, True)):
    tr = _guarded([100, 100])
    body, calls = tr._sample_collate, []

    def only_second(seeds, smask, keys, body=body, calls=calls):
      batch, _ = body(seeds, smask, keys)
      calls.append(None)
      return batch, torch.tensor(len(calls) == 2)

    tr._sample_collate = only_second
    tr.run_epoch(ttrain.create_train_state(tr.model), max_steps=max_steps)
    assert len(calls) == max_steps + 1
    assert tr.loader.check_overflow() == flagged


def test_recompute_refused():
  with pytest.raises(ValueError, match='recompute'):
    _guarded([1, 1], overflow_policy='recompute')
  tr = _guarded([1, 1])
  tr.loader.overflow_policy = 'recompute'
  with pytest.raises(ValueError, match='recompute'):
    tr.run_epoch(ttrain.create_train_state(tr.model))


def test_overlapped_reseeds_the_padded_window_as_the_loop_does():
  """Under padded-window sampling each later epoch starts on a reseeded
  table (``_begin_epoch``): two overlapped epochs equal two loop epochs
  bit for bit, table seed included."""
  kw = dict(padded_window=4, dedup='tree', shuffle=True)
  loader, model, _, want = _loop(2, **kw)
  tr = gtt.loader.OverlappedTrainer(_loader(**kw), _model(), C)
  state = ttrain.create_train_state(tr.model)
  got = []
  for _ in range(2):
    state, losses = tr.run_epoch(state)
    got += losses
  assert torch.equal(torch.stack(got), want)
  for a, b in zip(_params(tr.model), _params(model)):
    assert torch.equal(a, b)
  assert tr.loader._epochs_started == loader._epochs_started == 2
  assert tr._sampler._padded_seed == loader.sampler._padded_seed == 1


class _EpochFault(RuntimeError):
  """The failure the bracket test injects."""


def _fail_at(where, pkg, trainer, zeros_owner, monkeypatch):
  """Make ``trainer.run_epoch`` fail right after its flight record opens:
  at the epoch's first allocation (``zeros_owner.zeros``, armed by the
  opener) or at its first batch."""
  if where == 'first_batch':
    def seed_batches():
      raise _EpochFault('first batch')
      yield   # pragma: no cover (a generator that raises on first use)
    monkeypatch.setattr(trainer, '_seed_batches', seed_batches)
    return
  armed, real_zeros = [], zeros_owner.zeros
  real_begin = pkg.metrics.flight.epoch_begin

  def zeros(*args, **kwargs):
    if armed:
      armed.clear()
      raise _EpochFault('allocation')
    return real_zeros(*args, **kwargs)

  def epoch_begin():
    tok = real_begin()
    armed.append(True)
    return tok

  monkeypatch.setattr(zeros_owner, 'zeros', zeros)
  monkeypatch.setattr(pkg.metrics.flight, 'epoch_begin', epoch_begin)


@pytest.mark.parametrize('where', ['allocation', 'first_batch'])
def test_a_failed_epoch_start_closes_its_flight_record_as_jax(
    where, tmp_path, monkeypatch):
  """An epoch that fails between its flight record's opener and its first
  step still writes the record, with ``completed=False``, and leaves no
  span on the thread's stack: JAX's trainer on the same failure writes
  the same record."""
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  jloader = glt.loader.NeighborLoader(ds, [3, 2], _pool(), batch_size=8,
                                      shuffle=False, seed=0)
  jmodel = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(jloader)))
  jstate, tx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0), first)
  trainers = {
      'jax': (glt, glt.loader.OverlappedTrainer(jloader, jmodel, tx, C),
              jax.numpy, jstate),
      'port': (gtt, gtt.loader.OverlappedTrainer(_loader(), _model(), C),
               torch, None)}
  records = {}
  for name, (pkg, trainer, zeros_owner, state) in trainers.items():
    log = tmp_path / f'{name}.jsonl'
    with monkeypatch.context() as m:
      m.setenv('GLT_RUN_LOG', str(log))
      _fail_at(where, pkg, trainer, zeros_owner, m)
      if state is None:
        state = ttrain.create_train_state(trainer.model)
      with pytest.raises(_EpochFault, match=where.replace('_', ' ')):
        trainer.run_epoch(state)
    assert pkg.metrics.spans.current() == (None, None), name
    records[name] = pkg.metrics.flight.read_records(str(log))
  for name, recs in records.items():
    assert [(r['emitter'], r['steps'], r['completed'], r['truncated'])
            for r in recs] == [('OverlappedTrainer', 0, False, False)], name
  drop = ('wall_s', 'time_unix', 'run_id')
  want, got = ({k: v for k, v in records[n][0].items() if k not in drop}
               for n in ('jax', 'port'))
  assert got == want
