"""Crash, resume and failover of the port's scanned distributed epoch.

Mirrors the distributed part of ``tests/test_recovery.py`` (``:588``,
``:619``, ``:649``) on the 40-node ring of ``tests/test_distributed.py``
(P = 2 to 4, 2 seeds a shard, chunks of K = 2) on a one-process CPU
``ShardMesh``. On the CPU the port sums in a fixed order, so a crash at
a chunk boundary and a resume in a fresh trainer (through
``recovery.ChunkCheckpointer``) give the uninterrupted epoch's losses
and parameters bit for bit, and the feature store's counters exactly
(they ride the snapshot). A snapshot of a finished epoch resumes as
"advance past it", and the next epoch equals the uninterrupted run's.
``recovery.FailoverRunner`` with a stub liveness object (a rank that
reads dead from a given boundary poll on) rolls back at most one chunk
and trains every seed of the pool exactly once over the survivors;
``remaining_seeds`` equals the JAX package's replay.
"""
import copy

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.recovery import (ChunkCheckpointer,
                                           FailoverRunner, ShardDeadError,
                                           remaining_seeds, snapshot)

from test_torch_dist_scan import jax_loader, port_loader, port_model
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

K = 2
POOL = np.arange(20)       # 5 steps on P = 2 (4 seeds a step)


def trainer_for(model, p=2, seeds=POOL, **kw):
  kw.setdefault('shuffle', True)
  return gtt.loader.DistScanTrainer(port_loader(p, seeds, **kw), model, 3,
                                    chunk_size=K)


def crash_at(trainer, chunk):
  def killer(c, start, k):
    if c == chunk:
      raise RuntimeError('injected mid-epoch crash')
  trainer.stage_hook = killer


def snapshot_params(model):
  return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_params_equal(model, want):
  got = dict(model.named_parameters())
  assert set(got) == set(want)
  for n, v in want.items():
    assert torch.equal(got[n], v), n


@pytest.fixture(scope='module')
def ref():
  """Two uninterrupted epochs: losses, parameters and counters."""
  model0 = port_model()
  model = copy.deepcopy(model0)
  trainer = trainer_for(model)
  store = trainer.loader.sampler.dist_feature
  state = gtt.models.create_train_state(model, lr=1e-2)
  with published({0: store}) as stats:
    state, losses, _ = trainer.run_epoch(state)
  out = dict(model0=model0, losses=losses.numpy(),
             params=snapshot_params(model), stats=stats[0])
  with published({0: store}) as stats2:
    state, losses2, _ = trainer.run_epoch(state)
  out.update(losses2=losses2.numpy(), params2=snapshot_params(model),
             stats2=stats2[0])
  assert stats[0]['lookups'] > 0 and stats2[0]['lookups'] > 0
  return out


def test_crash_and_resume_bit_identical_with_exact_counters(ref, tmp_path):
  ckdir = str(tmp_path / 'ck')
  victim_model = copy.deepcopy(ref['model0'])
  victim = trainer_for(victim_model)
  ck = ChunkCheckpointer(ckdir, every=1).attach(victim)
  crash_at(victim, 2)
  with published({0: victim.loader.sampler.dist_feature}) as dropped:
    with pytest.raises(RuntimeError, match='injected'):
      victim.run_epoch(gtt.models.create_train_state(victim_model,
                                                     lr=1e-2))
  ck.close()
  # the failed epoch dropped its partial counts (its publish read
  # zeros); the boundary's are in the snapshot
  assert dropped[0]['lookups'] == 0
  assert victim.loader.sampler.dist_feature.stats()['lookups'] == 0
  snap = ChunkCheckpointer(ckdir).latest()
  assert snap.meta['next_start'] == 4 and 'extra:stats:' in snap.arrays
  fresh_model = copy.deepcopy(ref['model0'])
  fresh = trainer_for(fresh_model)
  metrics.reset('recovery')
  with published({0: fresh.loader.sampler.dist_feature}) as got:
    state, losses, _ = ChunkCheckpointer(ckdir).resume_epoch(
        fresh, gtt.models.create_train_state(fresh_model, lr=1e-2))
  assert metrics.snapshot()['counters']['recovery.resume_chunks'] == 1
  np.testing.assert_array_equal(losses, ref['losses'])
  assert_params_equal(fresh_model, ref['params'])
  assert state.step == 5
  assert got[0] == ref['stats']
  assert fresh._epochs == 1 and fresh._sampler._call_count == 5


def test_completed_epoch_snapshot_advances(ref, tmp_path):
  ckdir = str(tmp_path / 'ck')
  model_a = copy.deepcopy(ref['model0'])
  ta = trainer_for(model_a)
  cka = ChunkCheckpointer(ckdir, every=1).attach(ta)
  ta.run_epoch(gtt.models.create_train_state(model_a, lr=1e-2))
  cka.close()
  assert snapshot.list_snapshots(ckdir)[-1][1] == 5   # the final boundary
  model_b = copy.deepcopy(ref['model0'])
  tb = trainer_for(model_b)
  sb, lb, _ = ChunkCheckpointer(ckdir).resume_epoch(
      tb, gtt.models.create_train_state(model_b, lr=1e-2))
  np.testing.assert_array_equal(lb, ref['losses'])
  assert_params_equal(model_b, ref['params'])
  assert tb._epochs == 1
  # the finished epoch's counters are not restored: the next epoch's
  # equal the uninterrupted run's second epoch alone
  with published({0: tb.loader.sampler.dist_feature}) as got:
    sb, lb2, _ = tb.run_epoch(sb)
  np.testing.assert_array_equal(lb2.numpy(), ref['losses2'])
  assert_params_equal(model_b, ref['params2'])
  assert got[0] == ref['stats2']


class BoundaryLiveness:
  """Rank ``rank`` reads dead from poll ``after + 1`` on (the poll at the
  epoch's start is the first, each chunk boundary one more)."""

  def __init__(self, rank, after):
    self.rank, self.after, self.calls = rank, after, 0

  def dead_ranks(self):
    self.calls += 1
    return {self.rank: 'probe timeout'} if self.calls > self.after else {}


class Recording(gtt.loader.DistScanTrainer):
  """Records the valid seeds of every chunk it trains."""
  trained = []

  def _chunk(self, state, seeds, masks, base_key, counter):
    Recording.trained.append(seeds[masks].numpy().copy())
    return super()._chunk(state, seeds, masks, base_key, counter)


def _recording(model, p, seeds, shuffle):
  return Recording(port_loader(p, seeds, shuffle=shuffle), model, 3,
                   chunk_size=K)


@pytest.mark.parametrize('after,rank,same_model', [(2, 2, True),
                                                   (0, 1, True),
                                                   (3, 0, False)])
def test_failover_trains_every_seed_exactly_once(after, rank, same_model):
  pool = np.arange(36)            # 5 steps on P = 4, the last ragged
  model = port_model()
  models = [model]

  def rebuild(remaining, survivors):
    m = model if same_model else copy.deepcopy(models[-1])
    models.append(m)
    return _recording(m, survivors, remaining, shuffle=False)

  Recording.trained = []
  trainer = _recording(model, 4, pool, shuffle=True)
  metrics.reset('recovery')
  runner = FailoverRunner(trainer, rebuild,
                          liveness=BoundaryLiveness(rank, after))
  state, losses, accs, report = runner.run_epoch(
      gtt.models.create_train_state(model, lr=1e-2))
  (fo,) = report['failovers']
  assert fo['rank'] == rank and fo['survivors'] == 3
  # detection at boundary c: chunks before c are acked, none is lost
  assert fo['detected_chunk'] - fo['rolled_back_chunk'] <= 1
  assert fo['rolled_back_chunk'] == max(after - 1, 0)
  seg0, seg1 = report['segments']
  assert seg0['num_parts'] == 4 and seg1['num_parts'] == 3
  assert seg0['steps'] * 4 * 2 + fo['remaining_seeds'] == pool.size
  trained = np.concatenate(Recording.trained)
  assert np.array_equal(np.sort(trained), pool)       # each seed once
  assert losses.shape == accs.shape == (seg0['steps'] + seg1['steps'],)
  assert np.isfinite(losses).all()
  assert metrics.snapshot()['counters']['recovery.rollbacks'] == 1
  assert state.step == losses.shape[0]
  assert len(models) == 2


def test_failover_resumes_from_the_rollback_state():
  """The replacement trainer starts from the acknowledged boundary: its
  first loss equals a fresh trainer's over the same remaining seeds
  from the parameters the first segment left."""
  pool = np.arange(36)
  model = port_model()
  seen = {}

  def rebuild(remaining, survivors):
    seen['params'] = snapshot_params(model)
    seen['remaining'] = remaining
    return _recording(model, survivors, remaining, shuffle=False)

  runner = FailoverRunner(_recording(model, 4, pool, shuffle=True),
                          rebuild, liveness=BoundaryLiveness(2, 2))
  ref_model = copy.deepcopy(port_model())
  state, losses, _, report = runner.run_epoch(
      gtt.models.create_train_state(model, lr=1e-2))
  steps0 = report['segments'][0]['steps']
  # an independent run: the first segment alone, then the survivors
  first = _recording(ref_model, 4, pool, shuffle=True)
  sr = gtt.models.create_train_state(ref_model, lr=1e-2)
  sr, l0, _ = first.run_epoch(sr, max_steps=steps0)
  assert_params_equal(ref_model, seen['params'])
  second = _recording(ref_model, 3, seen['remaining'], shuffle=False)
  sr, l1, _ = second.run_epoch(sr)
  np.testing.assert_array_equal(losses, torch.cat([l0, l1]).numpy())


def test_failover_refusals_and_give_up():
  model = port_model()
  runner = FailoverRunner(trainer_for(model, 4, np.arange(36)),
                          lambda r, s: None)
  with pytest.raises(ValueError, match='full epochs'):
    runner.run_epoch(gtt.models.create_train_state(model), max_steps=2)
  reshuffled = FailoverRunner(
      trainer_for(model, 4, np.arange(36)),
      lambda r, s: trainer_for(model, s, r, shuffle=True),
      liveness=BoundaryLiveness(1, 0))
  with pytest.raises(ValueError, match='shuffle=False'):
    reshuffled.run_epoch(gtt.models.create_train_state(model))

  class TwoDead:
    def dead_ranks(self):
      return {1: 'a', 2: 'b'}

  twice = FailoverRunner(
      trainer_for(model, 4, np.arange(36)),
      lambda r, s: trainer_for(model, s, r, shuffle=False),
      liveness=TwoDead(), max_failovers=1)
  with pytest.raises(ShardDeadError, match='rank 2'):
    twice.run_epoch(gtt.models.create_train_state(model))


@pytest.mark.parametrize('shuffle,boundary', [(True, 2), (False, 4),
                                              (True, 0)])
def test_remaining_seeds_equal_jax(shuffle, boundary):
  import optax
  from graphlearn_tpu.recovery.failover import \
      remaining_seeds as jax_remaining
  pool = np.arange(3, 39)
  jt = glt.loader.DistScanTrainer(
      jax_loader(4, pool, shuffle=shuffle),
      glt.models.GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2),
      optax.adam(1e-2), 3, chunk_size=K)
  tt = trainer_for(port_model(), 4, pool, shuffle=shuffle)
  for epoch in (0, 1):
    jt._epochs = tt._epochs = epoch
    got = remaining_seeds(tt, boundary)
    np.testing.assert_array_equal(got, jax_remaining(jt, boundary))
    assert got.size == pool.size - boundary * 8
