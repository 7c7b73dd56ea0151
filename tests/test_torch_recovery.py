"""The port's chunk-granular recovery against its own uninterrupted epoch
and against the JAX package.

Mirrors the local parts of ``tests/test_recovery.py`` (ScanTrainer; the
tiered, distributed and failover parts come with their slices), at its
size: 96 nodes, 6 features, 3 classes, fanouts [3, 2], 44 seeds at batch
8 (6 steps, the last ragged) in chunks of 2. On the CPU the port's steps
sum in a fixed order, so a crash and resume is bit-identical to the
uninterrupted epoch; against the JAX package the losses agree within
atol 1e-5, rtol 1e-4. The snapshot file format is the JAX package's:
each package decodes the other's blobs.
"""
import os

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.metrics import flight as jflight
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu.recovery import ChunkCheckpointer as JaxCheckpointer
from graphlearn_tpu.recovery import snapshot as jsnapshot
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.recovery import (ChunkCheckpointer,
                                           TornSnapshotError,
                                           config_fingerprint, snapshot)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 96, 6, 3
SEEDS, BATCH, K = 44, 8, 2          # 6 steps -> 3 chunks of K = 2
TOL = dict(atol=1e-5, rtol=1e-4)


def _graph(seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _pool(num=SEEDS):
  return np.random.default_rng(9).permutation(N)[:num].astype(np.int64)


def _loader(pool=None, **kw):
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', BATCH)
  kw.setdefault('shuffle', True)
  kw.setdefault('seed', 0)
  return gtt.loader.NeighborLoader(ds, [3, 2], _pool() if pool is None
                                   else pool, device='cpu', **kw)


def _jax_loader(**kw):
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  kw.setdefault('batch_size', BATCH)
  kw.setdefault('shuffle', True)
  kw.setdefault('seed', 0)
  return glt.loader.NeighborLoader(ds, [3, 2], _pool(), **kw)


def _model(seed=0):
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def _trainer(model_seed=0, chunk=K, **kw):
  """A fresh ScanTrainer over a fresh loader and model, and a fresh
  train state (the template a resume loads into)."""
  model = _model(model_seed)
  trainer = gtt.loader.ScanTrainer(_loader(**kw), model, C, chunk_size=chunk)
  return trainer, ttrain.create_train_state(model)


def _crash_at(trainer, chunk):
  def killer(c, start, k):
    if c == chunk:
      raise RuntimeError('injected mid-epoch crash')
  trainer.stage_hook = killer


def _params(model):
  return [p.detach().clone() for p in model.parameters()]


def _assert_params_equal(a, b):
  for x, y in zip(a, b):
    assert torch.equal(x, y)


def _count(name):
  return metrics.default_registry().counter_value(name)


@pytest.fixture(scope='module')
def ref():
  """Two uninterrupted shuffled epochs (and one unshuffled): the
  bit-identity references."""
  out = {}
  for shuffle in (True, False):
    trainer, state = _trainer(shuffle=shuffle)
    state, losses, accs = trainer.run_epoch(state)
    params = _params(trainer.model)
    state, losses2, _ = trainer.run_epoch(state)
    out[shuffle] = dict(losses=losses.numpy(), accs=accs.numpy(),
                        params=params, losses2=losses2.numpy(),
                        params2=_params(trainer.model))
  return out


def test_snapshot_roundtrip_and_torn_detection(tmp_path):
  meta = dict(epoch=3, next_start=8, trainer='ScanTrainer',
              sampler={'call_count': 7,
                       'base_key': np.asarray([1, 2], np.uint32)},
              overflow=False)
  arrays = {'param:w': np.arange(12, dtype=np.float32).reshape(3, 4),
            'losses': np.asarray([0.5, 0.25], np.float32)}
  blob = snapshot.encode(meta, arrays)
  snap = snapshot.decode(blob)
  assert snap.meta['epoch'] == 3 and snap.next_start == 8
  np.testing.assert_array_equal(snap.meta['sampler']['base_key'], [1, 2])
  np.testing.assert_array_equal(snap.arrays['losses'], arrays['losses'])
  for cut in (4, len(blob) // 2, len(blob) - 3):
    with pytest.raises(TornSnapshotError):
      snapshot.decode(blob[:cut])
  flipped = bytearray(blob)
  flipped[-5] ^= 0xFF
  with pytest.raises(TornSnapshotError):
    snapshot.decode(bytes(flipped))
  with pytest.raises(TornSnapshotError):
    snapshot.decode(b'NOTGLT' + blob)
  d = str(tmp_path)
  snapshot.write_snapshot(d, dict(meta, epoch=0, next_start=4), arrays)
  snapshot.write_snapshot(d, dict(meta, epoch=0, next_start=2), arrays)
  snapshot.write_snapshot(d, dict(meta, epoch=1, next_start=2), arrays)
  listed = snapshot.list_snapshots(d)
  assert [(e, s) for e, s, _ in listed] == [(0, 2), (0, 4), (1, 2)]
  assert not [p for p in os.listdir(d) if p.endswith('.tmp')]
  loaded = snapshot.load_snapshot(listed[-1][2])
  assert loaded.epoch == 1 and loaded.path == listed[-1][2]


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_snapshot_format_parity(writer):
  """A blob either package encodes decodes in the other, meta and arrays
  equal; a torn blob is refused by both."""
  meta = dict(epoch=2, next_start=4, chunk=1, overflow=True,
              sampler={'call_count': 12, 'base_key': [0, 5]},
              lrs=[0.003], params=['convs.0.lin_l.weight'])
  arrays = {'param:convs.0.lin_l.weight':
            np.random.default_rng(0).standard_normal((8, 6)).astype(
                np.float32),
            'adam:convs.0.lin_l.weight:step': np.asarray(3.0, np.float32),
            'losses': np.asarray([1.5, 1.25, 1.0, 0.75], np.float32),
            'extra:eval:stop': np.asarray(False)}
  enc, dec = ((snapshot.encode, jsnapshot.decode) if writer == 'port'
              else (jsnapshot.encode, snapshot.decode))
  blob = enc(meta, arrays)
  snap = dec(blob)
  assert snap.meta == meta
  assert sorted(snap.arrays) == sorted(arrays)
  for k, v in arrays.items():
    assert snap.arrays[k].dtype == v.dtype
    np.testing.assert_array_equal(snap.arrays[k], v)
  for decode, err in ((snapshot.decode, TornSnapshotError),
                      (jsnapshot.decode, jsnapshot.TornSnapshotError)):
    with pytest.raises(err):
      decode(blob[:-7])


@pytest.mark.parametrize('every,kill_chunk,shuffle', [
    (1, 1, True), (1, 2, False), (2, 1, False), (2, 2, True),
    (2, 2, False), (3, 1, True)])
def test_crash_resume_bit_identical(ref, tmp_path, every, kill_chunk,
                                    shuffle):
  """A ScanTrainer killed at a chunk (cadence x kill chunk) resumes in a
  fresh trainer whose model starts from other weights: the whole
  epoch's losses and accuracies, the parameters, and the next epoch bit
  for bit the uninterrupted run's. Where the cadence missed every
  boundary before the kill there is nothing to resume: the epoch is run
  again from its start."""
  want = ref[shuffle]
  ckdir = str(tmp_path / 'ck')
  victim, state = _trainer(shuffle=shuffle)
  ck = ChunkCheckpointer(ckdir, every=every).attach(victim)
  _crash_at(victim, kill_chunk)
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(state)
  assert victim._steps_dispatched == kill_chunk * K
  ck.close()
  fresh, template = _trainer(model_seed=5, shuffle=shuffle)
  resumer = ChunkCheckpointer(ckdir)
  chunks0 = _count('recovery.resume_chunks')
  if snapshot.list_snapshots(ckdir):
    state, losses, accs = resumer.resume_epoch(fresh, template)
    assert _count('recovery.resume_chunks') - chunks0 == \
        3 - resumer.latest().next_start // K
  else:
    with pytest.raises(FileNotFoundError):
      resumer.resume_epoch(fresh, template)
    fresh.model.load_state_dict(_trainer()[0].model.state_dict())
    state, losses, accs = fresh.run_epoch(template)
    losses, accs = losses.numpy(), accs.numpy()
  np.testing.assert_array_equal(losses, want['losses'])
  np.testing.assert_array_equal(accs, want['accs'])
  _assert_params_equal(_params(fresh.model), want['params'])
  assert state.step == 6
  assert fresh._epochs == 1 and fresh._sampler._call_count == 6
  state, losses2, _ = fresh.run_epoch(state)
  np.testing.assert_array_equal(losses2.numpy(), want['losses2'])
  _assert_params_equal(_params(fresh.model), want['params2'])


def test_checkpointed_epoch_changes_no_loss_bit(ref, tmp_path):
  """A checkpointer at every boundary changes no loss, accuracy or
  parameter bit; it writes one snapshot per boundary (keep=2 on disk),
  each holding every parameter and Adam tensor by name and the epoch's
  losses so far."""
  saves0, bytes0 = _count('checkpoint.saves'), _count('checkpoint.bytes')
  tr, state = _trainer()
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(tr)
  state, losses, accs = tr.run_epoch(state)
  ck.flush()
  np.testing.assert_array_equal(losses.numpy(), ref[True]['losses'])
  np.testing.assert_array_equal(accs.numpy(), ref[True]['accs'])
  _assert_params_equal(_params(tr.model), ref[True]['params'])
  assert _count('checkpoint.saves') - saves0 == 3
  assert _count('checkpoint.bytes') > bytes0
  assert [s for _, s, _ in snapshot.list_snapshots(str(tmp_path))] == [4, 6]
  snap = ck.latest()
  names = [n for n, _ in tr.model.named_parameters()]
  assert snap.meta['params'] == names and snap.meta['train_step'] == 6
  assert snap.meta['lrs'] == [3e-3] and snap.meta['overflow'] is False
  for n, p in tr.model.named_parameters():
    np.testing.assert_array_equal(snap.arrays[f'param:{n}'],
                                  p.detach().numpy())
    for key in ('exp_avg', 'exp_avg_sq', 'step'):
      np.testing.assert_array_equal(
          snap.arrays[f'adam:{n}:{key}'],
          state.optimizer.state[p][key].numpy())
  np.testing.assert_array_equal(snap.arrays['losses'], ref[True]['losses'])
  ck.close()


def test_second_crash_during_resume(ref, tmp_path):
  """A resume that crashes again: the snapshots it wrote during the
  replay carry the checkpointed loss prefix, so a second resume, from
  the replay's own newest boundary, is still bit-identical."""
  ckdir = str(tmp_path)
  victim, state = _trainer()
  ck = ChunkCheckpointer(ckdir, every=1).attach(victim)
  _crash_at(victim, 1)
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(state)
  ck.close()
  fresh, template = _trainer(model_seed=3)
  ck2 = ChunkCheckpointer(ckdir, every=1).attach(fresh)
  _crash_at(fresh, 2)
  with pytest.raises(RuntimeError, match='injected'):
    ck2.resume_epoch(fresh, template)
  ck2.close()
  assert fresh._steps_dispatched == 4
  newest = ChunkCheckpointer(ckdir).latest()
  assert newest.next_start == 4
  np.testing.assert_array_equal(newest.arrays['losses'],
                                ref[True]['losses'][:4])
  fresh2, template2 = _trainer(model_seed=4)
  state, losses, _ = ChunkCheckpointer(ckdir).resume_epoch(fresh2,
                                                           template2)
  np.testing.assert_array_equal(losses, ref[True]['losses'])
  _assert_params_equal(_params(fresh2.model), ref[True]['params'])


def test_completed_epoch_snapshot_advances(ref, tmp_path):
  """The snapshot of a finished epoch resumes as "past it": no chunk is
  replayed, the counters land at the epoch's end, the state is the
  epoch's final one, and the next epoch is the reference's second."""
  tr, state = _trainer()
  ck = ChunkCheckpointer(str(tmp_path), every=2).attach(tr)
  tr.run_epoch(state)
  ck.close()
  fresh, template = _trainer(model_seed=7)
  resumes0 = _count('recovery.resumes')
  state, losses, accs = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  assert _count('recovery.resumes') == resumes0 + 1
  np.testing.assert_array_equal(losses, ref[True]['losses'])
  np.testing.assert_array_equal(accs, ref[True]['accs'])
  assert fresh._epochs == 1 and fresh._sampler._call_count == 6
  assert state.step == 6
  _assert_params_equal(_params(fresh.model), ref[True]['params'])
  state, losses2, _ = fresh.run_epoch(state)
  np.testing.assert_array_equal(losses2.numpy(), ref[True]['losses2'])


def test_resume_config_drift_refuses(tmp_path):
  """A drifted configuration (chunk size, batch size, seed pool, dedup)
  refuses to resume; a misaligned or out-of-epoch start_step is refused
  by the trainer itself."""
  ckdir = str(tmp_path)
  victim, state = _trainer()
  ck = ChunkCheckpointer(ckdir, every=1).attach(victim)
  _crash_at(victim, 2)
  with pytest.raises(RuntimeError):
    victim.run_epoch(state)
  ck.close()
  drifts = [dict(chunk=3), dict(batch_size=4), dict(dedup='tree'),
            dict(pool=np.arange(SEEDS, dtype=np.int64))]
  for drift in drifts:
    drifted, template = _trainer(**drift)
    with pytest.raises(ValueError, match='fingerprint'):
      ChunkCheckpointer(ckdir).resume_epoch(drifted, template)
  other = gtt.loader.RunTrainer(_loader(), _model(), C, chunk_size=K)
  with pytest.raises(ValueError, match='written by'):
    ChunkCheckpointer(ckdir).resume_epoch(
        other, ttrain.create_train_state(other.model))
  ok, template = _trainer()
  with pytest.raises(ValueError, match='chunk boundary'):
    ok.run_epoch(template, start_step=3)
  with pytest.raises(ValueError, match='outside'):
    ok.run_epoch(template, start_step=6)


def test_failing_writer_degrades_to_sync(ref, tmp_path, monkeypatch):
  """The writer thread's first save fails: the checkpointer counts the
  error, degrades to synchronous writes for the later boundaries, the
  epoch stays bit-identical, and the surviving snapshots resume; a torn
  newest snapshot is skipped for the one before it."""
  real = snapshot.write_snapshot
  calls = []

  def failing(directory, meta, arrays):
    calls.append(meta['next_start'])
    if len(calls) == 1:
      raise OSError('injected disk failure')
    return real(directory, meta, arrays)

  monkeypatch.setattr(snapshot, 'write_snapshot', failing)
  errors0, sync0 = _count('checkpoint.save_errors'), _count(
      'checkpoint.sync_fallback')
  ckdir = str(tmp_path)
  tr, state = _trainer()
  ck = ChunkCheckpointer(ckdir, every=1).attach(tr)
  state, losses, _ = tr.run_epoch(state)
  ck.flush()
  np.testing.assert_array_equal(losses.numpy(), ref[True]['losses'])
  _assert_params_equal(_params(tr.model), ref[True]['params'])
  assert ck.degraded and calls == [2, 4, 6]
  assert _count('checkpoint.save_errors') == errors0 + 1
  assert _count('checkpoint.sync_fallback') >= sync0 + 1
  ck.close()
  snaps = snapshot.list_snapshots(ckdir)
  assert [s for _, s, _ in snaps] == [4, 6]
  # tear the newest: the resume falls back to the boundary before it
  with open(snaps[-1][2], 'r+b') as fh:
    fh.truncate(os.path.getsize(snaps[-1][2]) - 31)
  torn0 = _count('checkpoint.torn_skipped')
  fresh, template = _trainer(model_seed=9)
  state2, losses2, _ = ChunkCheckpointer(ckdir).resume_epoch(fresh,
                                                             template)
  assert _count('checkpoint.torn_skipped') == torn0 + 1
  np.testing.assert_array_equal(losses2, ref[True]['losses'])
  _assert_params_equal(_params(fresh.model), ref[True]['params'])


def test_memory_snapshot_resumes(ref):
  """A memory-only checkpointer keeps the newest boundary on the host;
  ``resume_epoch`` takes it as it takes a file."""
  victim, state = _trainer()
  ck = ChunkCheckpointer(None, mem_every=1).attach(victim)
  _crash_at(victim, 2)
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(state)
  snap = ck.latest_mem
  assert snap.next_start == 4 and ck.latest() is None
  fresh, template = _trainer(model_seed=2)
  _, losses, _ = ChunkCheckpointer(None).resume_epoch(fresh, template,
                                                      snapshot=snap)
  np.testing.assert_array_equal(losses, ref[True]['losses'])
  _assert_params_equal(_params(fresh.model), ref[True]['params'])


def _jax_trainer(chunk=K, **kw):
  model = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(_jax_loader(**kw))))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0), first)
  return glt.loader.ScanTrainer(_jax_loader(**kw), model, tx, C,
                                chunk_size=chunk), state, model, tx, first


@pytest.mark.parametrize('kw', [dict(), dict(shuffle=False, drop_last=True),
                                dict(dedup='tree'),
                                dict(dedup='tree', padded_window=4)])
def test_recovery_config_fingerprint_matches_jax(kw):
  """For the same loader configuration both packages' recovery configs,
  and so their fingerprints, are equal."""
  jt = _jax_trainer(**kw)[0]
  pt = gtt.loader.ScanTrainer(_loader(**kw), _model(), C, chunk_size=K)
  assert pt._recovery_config() == jt._recovery_config()
  assert config_fingerprint(pt._recovery_config()) == \
      jflight.config_fingerprint(jt._recovery_config())


def test_crash_resume_agrees_with_jax(tmp_path):
  """The same crash (at chunk 2, cadence 2) and resume in each package,
  from the same weights: whole-epoch losses and accuracies and the final
  parameters within atol 1e-5, rtol 1e-4."""
  jt, jstate, jmodel, tx, first = _jax_trainer()
  params = jax.tree.map(np.asarray, jstate.params)
  jck = JaxCheckpointer(str(tmp_path / 'jax'), every=2).attach(jt)
  _crash_at(jt, 2)
  with pytest.raises(RuntimeError, match='injected'):
    jt.run_epoch(jstate)
  jck.close()
  jfresh = glt.loader.ScanTrainer(_jax_loader(), jmodel, tx, C, chunk_size=K)
  jtmpl, _ = jtrain.create_train_state(jmodel, jax.random.PRNGKey(5), first,
                                       optimizer=tx)
  jstate, jlosses, jaccs = JaxCheckpointer(
      str(tmp_path / 'jax')).resume_epoch(jfresh, jtmpl)

  victim, state = _trainer()
  victim.model.load_state_dict(convert.params_from_flax(params))
  ck = ChunkCheckpointer(str(tmp_path / 'port'), every=2).attach(victim)
  _crash_at(victim, 2)
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(state)
  ck.close()
  fresh, template = _trainer(model_seed=5)
  _, losses, accs = ChunkCheckpointer(str(tmp_path / 'port')).resume_epoch(
      fresh, template)
  np.testing.assert_allclose(losses, np.asarray(jlosses), **TOL)
  np.testing.assert_allclose(accs, np.asarray(jaccs), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params))
  for name, t in fresh.model.state_dict().items():
    np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)
  assert fresh._sampler._call_count == jfresh._sampler._call_count
  assert fresh._epochs == jfresh._epochs


# ------------------------------------------- padded-window recovery branches

PADDED = dict(padded_window=4, dedup='tree')


@pytest.fixture(scope='module')
def padded_ref():
  """Two uninterrupted padded-window epochs (the second on a reseeded
  table), with each epoch's table."""
  trainer, state = _trainer(**PADDED)
  out = {}
  for e in range(2):
    state, losses, accs = trainer.run_epoch(state)
    out[e] = dict(losses=losses.numpy(), accs=accs.numpy(),
                  params=_params(trainer.model),
                  tab=trainer._sampler._padded_arrays()['tab'].clone(),
                  seed=trainer._sampler._padded_seed)
  return out


def test_padded_capture_meta_matches_jax():
  """A boundary snapshot's padded counters: the table's seed and the
  loader's epochs begun, as the JAX trainer records them."""
  jt = _jax_trainer(**PADDED)[0]
  pt = gtt.loader.ScanTrainer(_loader(**PADDED), _model(), C, chunk_size=K)
  for _ in range(2):
    jt.loader._begin_epoch()
    pt.loader._begin_epoch()
    jmeta, _ = jt._recovery_capture(None)
    tmeta, _ = pt._recovery_capture(None)
    assert tmeta['padded'] == jmeta['padded']
  assert tmeta['padded'] == {'seed': 1, 'epochs_started': 2}


@pytest.mark.parametrize('crash_epoch', [0, 1])
def test_padded_crash_resume_rebuilds_the_epochs_table(padded_ref, tmp_path,
                                                       crash_epoch):
  """A padded-window epoch killed at chunk 1 (in the first epoch, or in
  the second, after a reseed) resumes in a fresh trainer on the same
  table: its losses, accuracies and parameters are the uninterrupted
  run's bit for bit, and so is the next epoch's table."""
  want = padded_ref[crash_epoch]
  victim, state = _trainer(**PADDED)
  for _ in range(crash_epoch):
    state, _, _ = victim.run_epoch(state)
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(victim)
  _crash_at(victim, 1)
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(state)
  ck.close()
  assert ck.latest().meta['padded'] == {'seed': want['seed'],
                                        'epochs_started': crash_epoch + 1}
  fresh, template = _trainer(model_seed=5, **PADDED)
  fresh._sampler._padded_arrays()      # a table built before the resume
  state, losses, accs = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  np.testing.assert_array_equal(losses, want['losses'])
  np.testing.assert_array_equal(accs, want['accs'])
  _assert_params_equal(_params(fresh.model), want['params'])
  assert fresh._sampler._padded_seed == want['seed']
  assert torch.equal(fresh._sampler._padded_arrays()['tab'], want['tab'])
  if crash_epoch == 0:
    state, losses2, _ = fresh.run_epoch(state)
    np.testing.assert_array_equal(losses2.numpy(), padded_ref[1]['losses'])
    assert torch.equal(fresh._sampler._padded_arrays()['tab'],
                       padded_ref[1]['tab'])


def test_padded_completed_epoch_snapshot_advances(padded_ref, tmp_path):
  """A finished padded epoch's snapshot resumes past it: the next
  run_epoch reseeds onto the second epoch's table and replays the
  uninterrupted second epoch bit for bit."""
  tr, state = _trainer(**PADDED)
  ck = ChunkCheckpointer(str(tmp_path), every=3).attach(tr)
  tr.run_epoch(state)
  ck.close()
  fresh, template = _trainer(model_seed=7, **PADDED)
  state, losses, _ = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  np.testing.assert_array_equal(losses, padded_ref[0]['losses'])
  assert fresh.loader._epochs_started == 1
  state, losses2, _ = fresh.run_epoch(state)
  np.testing.assert_array_equal(losses2.numpy(), padded_ref[1]['losses'])
  assert torch.equal(fresh._sampler._padded_arrays()['tab'],
                     padded_ref[1]['tab'])


def test_run_trainer_refuses_the_padded_window():
  with pytest.raises(ValueError, match='padded-window'):
    gtt.loader.RunTrainer(_loader(**PADDED), _model(), C, chunk_size=K,
                          epochs=2)
