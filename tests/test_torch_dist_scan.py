"""The port's scanned distributed epoch against the JAX package's.

Fixture: ``tests/test_dist_scan_epoch.py``'s 40-node ring (node_pb = v %
P, ``feat[v] = v``, labels v % 3, a 25% hot cache), P = 2 and 4, fanouts
[2, 2], 2 seeds a shard, chunks of K = 2. JAX runs its
``DistScanTrainer`` (a shard_map scan per chunk length) on the
conftest's 8-device CPU mesh; the port runs ``loader.DistScanTrainer``
eagerly on a one-process CPU ``ShardMesh`` (a CPU mesh is never
captured). Held exactly: the distributed chunk keys
(``ops.dist_step_keys``, also through a numpy emulation of the CUDA
kernel thread by thread), the epoch's ``[P, steps, B]`` seed and mask
matrices (shuffle on and off, ragged tail) and the feature-cache
counters. Within atol 1e-5 / rtol 1e-4: two epochs' losses and
parameters against JAX's (the port's Adam places optax's bias
corrections differently). Bit-exact: the port's scanned epoch against
its own per-step loop (``run_epoch_steps``), tree and merge, with a
ragged tail batch, a tail chunk, the fractional exchange's counted
verdicts and a second epoch. Then the overflow guard and the refusals,
mirroring ``tests/test_dist_scan_epoch.py``.
"""
import copy

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.typing import GraphPartitionData as JPart
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch import random as trandom
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart

from test_torch_keys import _threefry
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40
K = 2
TOL = dict(atol=1e-5, rtol=1e-4)
STATS = ('hits', 'misses', 'unique_misses', 'overflow', 'lookups')


def ring(num_parts, part_cls):
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  eids = np.arange(2 * N)
  node_pb = (np.arange(N) % num_parts).astype(np.int32)
  edge_pb = node_pb[rows]
  parts, feats = [], []
  for p in range(num_parts):
    m = edge_pb == p
    parts.append(part_cls(edge_index=np.stack([rows[m], cols[m]]),
                          eids=eids[m]))
    ids = np.nonzero(node_pb == p)[0]
    feats.append((ids.astype(np.int64),
                  ids[:, None].astype(np.float32) * np.ones((1, 4),
                                                            np.float32)))
  return parts, feats, node_pb, edge_pb


def jmesh(p):
  import jax
  from jax.sharding import Mesh
  return Mesh(np.array(jax.devices()[:p]), ('g',))


def jax_loader(p, seeds, **kw):
  parts, feats, node_pb, edge_pb = ring(p, JPart)
  mesh = jmesh(p)
  dg = glt.distributed.DistGraph(p, 0, parts, node_pb, edge_pb)
  df = glt.distributed.DistFeature(p, feats, node_pb, mesh,
                                   split_ratio=0.25)
  ds = glt.distributed.DistDataset(p, 0, dg, df,
                                   node_labels=np.arange(N) % 3)
  kw.setdefault('shuffle', False)
  kw.setdefault('drop_last', False)
  return glt.distributed.DistNeighborLoader(
      ds, [2, 2], np.asarray(seeds), batch_size=2, seed=0, mesh=mesh, **kw)


def port_loader(p, seeds, feature_kw=None, **kw):
  parts, feats, node_pb, edge_pb = ring(p, TPart)
  mesh = gdist.ShardMesh(p, 'cpu')
  dg = gdist.DistGraph(p, 0, parts, node_pb, edge_pb)
  fkw = dict(split_ratio=0.25)
  fkw.update(feature_kw or {})
  df = gdist.DistFeature(p, feats, node_pb, mesh, **fkw)
  ds = gdist.DistDataset(p, 0, dg, df, node_labels=np.arange(N) % 3)
  kw.setdefault('shuffle', False)
  kw.setdefault('drop_last', False)
  return gdist.DistNeighborLoader(ds, [2, 2], np.asarray(seeds),
                                  batch_size=2, seed=0, mesh=mesh, **kw)


def port_model(params=None):
  model = gtt.models.GraphSAGE(4, 8, 3, num_layers=2, device='cpu',
                               generator=torch.Generator().manual_seed(0))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  return model


def assert_params_close(model, jparams):
  want = convert.params_from_flax(jparams)
  got = model.state_dict()
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                               err_msg=name, **TOL)


# ------------------------------------------------------------------- keys

def _dist_kernel_emulation(base_key, counter, n_steps, n_parts, n_hops):
  """``dist_step_keys_kernel``, thread by thread: fold_in is threefry(base,
  (0, count)), the shard key threefry(folded, (0, p)), the hop key
  threefry(shard key, (0, h))."""
  out = np.zeros((n_steps, n_parts, n_hops, 2), np.int64)
  k0, k1 = (int(w) & 0xFFFFFFFF for w in base_key)
  for i in range(n_steps * n_parts * n_hops):
    j, r = divmod(i, n_parts * n_hops)
    p, h = divmod(r, n_hops)
    x0, x1 = _threefry(k0, k1, 0, (counter + j) & 0xFFFFFFFF)
    s0, s1 = _threefry(int(x0), int(x1), 0, p)
    y0, y1 = _threefry(int(s0), int(s1), 0, h)
    out[j, p, h] = int(y0), int(y1)
  return out


@pytest.mark.parametrize('count,n_steps,n_parts,n_hops', [
    (1, 4, 2, 2), (5, 3, 4, 3), (2 ** 31 - 2, 4, 3, 1),
    (2 ** 32 - 3, 4, 2, 2)])
def test_dist_chunk_keys_equal_jax_split_of_fold_in(count, n_steps, n_parts,
                                                    n_hops):
  import jax
  base = jax.random.PRNGKey(7)
  want = np.stack([np.stack([
      np.asarray(jax.random.split(k, n_hops)) for k in jax.random.split(
          jax.random.fold_in(base, np.uint32((count + j) & 0xFFFFFFFF)),
          n_parts)]) for j in range(n_steps)]).astype(np.int64)
  tkey = trandom.PRNGKey(7)
  ops.reset_launch_counts()
  got = ops.dist_step_keys(tkey, torch.tensor(count), n_steps, n_parts,
                           n_hops)
  assert ops.launch_counts()['dist_step_keys'] == 0   # the plain version
  assert got.shape == (n_steps, n_parts, n_hops, 2)
  np.testing.assert_array_equal(got.numpy(), want)
  plain = trandom.dist_step_keys_plain(
      tkey, count + torch.arange(n_steps), n_parts, n_hops)
  np.testing.assert_array_equal(plain.numpy(), want)
  np.testing.assert_array_equal(
      _dist_kernel_emulation(tkey.tolist(), count, n_steps, n_parts,
                             n_hops), want)


def test_dist_chunk_keys_are_the_samplers_per_step_keys():
  """Step j's shard keys split per hop are ``_homo_hop_loop``'s split of
  ``DistNeighborSampler._keys_for(count + j)``."""
  loader = port_loader(4, np.arange(16))
  s = loader.sampler
  keys = ops.dist_step_keys(s._key, torch.tensor(3), 2, 4, 2)
  for j in range(2):
    want = trandom.split(s._keys_for(3 + j), 2)
    assert torch.equal(keys[j], want)


# ------------------------------------------------------------ seed matrix

@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('p,num_seeds,steps', [(2, 20, 5), (2, 20, 6),
                                               (4, 38, 3), (4, 16, 1)])
def test_seed_and_mask_matrices_equal_jax(shuffle, p, num_seeds, steps):
  import jax
  import optax
  jl = jax_loader(p, np.arange(num_seeds), shuffle=shuffle)
  jt = glt.loader.DistScanTrainer(
      jl, glt.models.GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2),
      optax.adam(1e-2), 3, chunk_size=K)
  tl = port_loader(p, np.arange(num_seeds), shuffle=shuffle)
  tt = gtt.loader.DistScanTrainer(tl, port_model(), 3, chunk_size=K)
  seeds = np.arange(100, 100 + num_seeds, dtype=np.int32)
  for epoch in (0, 1):
    jm, jmask = jt._seed_fn(jax.numpy.asarray(seeds),
                            jax.random.fold_in(jt._perm_key, epoch), steps)
    tm, tmask = tt._seed_fn(torch.as_tensor(seeds),
                            trandom.fold_in(tt._perm_key, epoch), steps)
    assert tm.shape == (p, steps, 2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
  total = p * steps * 2
  assert int(tmask.sum()) == min(total, num_seeds)


# ------------------------------------------------------- against JAX

P_REF = 2
REF_SEEDS = np.arange(2, 20)       # 18 seeds, global batch 4: 5 steps


def _jax_state(model, tx, loader):
  import jax
  import jax.numpy as jnp
  from graphlearn_tpu.models import train as jtrain
  first = next(iter(loader))
  params = model.init(jax.random.PRNGKey(0), np.asarray(first.x)[0],
                      np.asarray(first.edge_index)[0],
                      np.asarray(first.edge_mask)[0])
  return jtrain.TrainState(params, tx.init(params), jnp.int32(0))


@pytest.fixture(scope='module')
def jax_ref():
  """Two shuffled epochs of JAX's DistScanTrainer (the tail chunk of one
  step included), their published feature counters and parameters."""
  import gc

  import jax
  import optax
  model = glt.models.GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2)
  tx = optax.adam(1e-2)
  trainer = glt.loader.DistScanTrainer(
      jax_loader(P_REF, REF_SEEDS, shuffle=True), model, tx, 3,
      chunk_size=K)
  state = _jax_state(model, tx, jax_loader(P_REF, REF_SEEDS))
  params0 = jax.device_get(state.params)
  gc.collect()
  glt.utils.trace.reset_counters('dist_feature')
  out = dict(params0=params0)
  for e in (1, 2):
    state, losses, accs = trainer.run_epoch(state)
    out[f'losses{e}'] = np.asarray(losses)
    out[f'accs{e}'] = np.asarray(accs)
    out[f'params{e}'] = jax.device_get(state.params)
    out[f'stats{e}'] = glt.utils.trace.counters('dist_feature')
    glt.utils.trace.reset_counters('dist_feature')
  return out


def test_scanned_epochs_equal_jax(jax_ref):
  model = port_model(jax_ref['params0'])
  loader = port_loader(P_REF, REF_SEEDS, shuffle=True)
  trainer = gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=K)
  state = gtt.models.create_train_state(model, lr=1e-2)
  for e in (1, 2):
    # the epoch publishes its store's counters at its end, as JAX's does
    gtt.utils.trace.reset_counters('dist_feature')
    state, losses, accs = trainer.run_epoch(state)
    assert losses.shape == (5,) and state.step == 5 * e
    np.testing.assert_allclose(losses.numpy(), jax_ref[f'losses{e}'], **TOL)
    np.testing.assert_allclose(accs.numpy(), jax_ref[f'accs{e}'], **TOL)
    assert_params_close(model, jax_ref[f'params{e}'])
    st = gtt.utils.trace.counters('dist_feature')
    want = {k: jax_ref[f'stats{e}'].get(f'dist_feature.{k}', 0)
            for k in STATS}
    assert {k: st.get(f'dist_feature.{k}', 0) for k in STATS} == want
    assert want['lookups'] > 0
  assert loader.sampler._call_count == 10 and trainer._epochs == 2


# ------------------------------------------------ against the port's loop

@pytest.mark.parametrize('p,num_seeds,chunk,kw', [
    (2, 38, 4, dict(dedup='tree', bucket_frac=None)),   # 10 steps: 4,4,2
    (4, 30, 2, dict(dedup='merge')),                    # 4 steps, ragged
])
def test_scanned_epoch_equals_the_per_step_loop(p, num_seeds, chunk, kw):
  model_a = port_model()
  model_b = copy.deepcopy(model_a)
  fkw = dict(bucket_frac=kw.get('bucket_frac', 2.0))
  ref_loader = port_loader(p, np.arange(num_seeds), fkw, **kw)
  scan_loader = port_loader(p, np.arange(num_seeds), fkw, **kw)
  ref = gtt.loader.DistFusedEpochTrainer(ref_loader, model_a, 3)
  trainer = gtt.loader.DistScanTrainer(scan_loader, model_b, 3,
                                       chunk_size=chunk)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  steps = len(ref_loader)
  for _ in range(2):
    gdist.reset_verdict_syncs()
    with published({0: ref_loader.sampler.dist_feature}) as ref_stats:
      sa, la = ref.run_epoch_steps(sa)
    syncs_ref = gdist.verdict_syncs()
    gdist.reset_verdict_syncs()
    with published({0: scan_loader.sampler.dist_feature}) as scan_stats:
      sb, lb, ab = trainer.run_epoch(sb)
    assert gdist.verdict_syncs() == syncs_ref
    assert len(la) == steps == lb.shape[0] == ab.shape[0]
    assert torch.equal(torch.stack(la), lb)
    for x, y in zip(model_a.parameters(), model_b.parameters()):
      assert torch.equal(x, y)
    # each epoch published its store's counters once, at its end
    assert ref_stats == scan_stats and ref_stats[0]['lookups'] > 0
    assert ref_loader.sampler._call_count == \
        scan_loader.sampler._call_count
  if kw.get('bucket_frac', 2.0) is None:
    assert syncs_ref == 0
  elif p == 4:
    assert syncs_ref > 0


def test_max_steps_truncates_and_the_stream_advances_by_it():
  model_a = port_model()
  model_b = copy.deepcopy(model_a)
  trainer = gtt.loader.DistScanTrainer(port_loader(2, np.arange(38)),
                                       model_a, 3, chunk_size=4)
  ref = gtt.loader.DistFusedEpochTrainer(port_loader(2, np.arange(38)),
                                         model_b, 3)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  sa, la, _ = trainer.run_epoch(sa, max_steps=5)
  sb, lb = ref.run_epoch_steps(sb, max_steps=5)
  assert torch.equal(la, torch.stack(lb)) and sa.step == 5
  assert trainer._sampler._call_count == 5 and trainer._epochs == 1


# --------------------------------------------------- guard and refusals

def test_overflow_guard_raises_at_epoch_end_and_defers_on_max_steps():
  spread = (np.arange(16) * 13) % N
  model = port_model()

  def mk():
    return port_loader(2, spread, dedup='merge', frontier_caps=[8, 2],
                       drop_last=True)

  trainer = gtt.loader.DistScanTrainer(mk(), model, 3, chunk_size=2)
  state = gtt.models.create_train_state(model, lr=1e-2)
  with pytest.raises(RuntimeError, match='frontier_caps overflowed'):
    trainer.run_epoch(state)
  loader2 = mk()
  trainer2 = gtt.loader.DistScanTrainer(loader2, model, 3, chunk_size=2)
  trainer2.run_epoch(gtt.models.create_train_state(model), max_steps=2)
  assert loader2.check_overflow()


def test_refusals_name_their_reason():
  model = port_model()

  class FakeRemoteLoader:
    pass

  with pytest.raises(ValueError, match='collocated'):
    gtt.loader.DistScanTrainer(FakeRemoteLoader(), model, 3)
  with pytest.raises(ValueError, match='recompute'):
    gtt.loader.DistScanTrainer(
        port_loader(2, np.arange(16), dedup='merge', frontier_caps=[8, 8],
                    overflow_policy='recompute'), model, 3)
  with pytest.raises(ValueError, match='chunk_size'):
    gtt.loader.DistScanTrainer(port_loader(2, np.arange(16)), model, 3,
                               chunk_size=0)
  with pytest.raises(ValueError, match='with_edge'):
    gtt.loader.DistFusedEpochTrainer(
        port_loader(2, np.arange(16), with_edge=True), model, 3)
  with pytest.raises(ValueError, match='collect_features'):
    gtt.loader.DistScanTrainer(
        port_loader(2, np.arange(16), collect_features=False), model, 3)
  unlabeled = port_loader(2, np.arange(16))
  unlabeled.data.node_labels = None
  with pytest.raises(ValueError, match='node labels'):
    gtt.loader.DistScanTrainer(unlabeled, model, 3)
  # link and subgraph loaders keep the per-step loop, as in JAX
  parts, feats, node_pb, edge_pb = ring(2, TPart)
  mesh = gdist.ShardMesh(2, 'cpu')
  ds = gdist.DistDataset(2, 0, gdist.DistGraph(2, 0, parts, node_pb,
                                               edge_pb),
                         gdist.DistFeature(2, feats, node_pb, mesh),
                         node_labels=np.arange(N) % 3)
  link = gdist.DistLinkNeighborLoader(
      ds, [2], np.stack([np.arange(8), (np.arange(8) + 1) % N]),
      batch_size=2, mesh=mesh)
  with pytest.raises(ValueError, match='NODE'):
    gtt.loader.DistScanTrainer(link, model, 3)
  sub = gdist.DistSubGraphLoader(ds, None, np.arange(8), batch_size=2,
                                 mesh=mesh)
  with pytest.raises(ValueError, match='NODE'):
    gtt.loader.DistFusedEpochTrainer(sub, model, 3)


def test_capture_needs_full_width_exchanges_and_a_card():
  """A fractional exchange reads its verdict on the host, which a CUDA
  graph cannot: capture=True refuses it and names bucket_frac=None;
  with full-width exchanges a CPU mesh is refused for want of a card.
  Nothing switches silently: capture=False runs the same loader."""
  model = port_model()
  with pytest.raises(ValueError, match='bucket_frac=None'):
    gtt.loader.DistScanTrainer(port_loader(2, np.arange(16)), model, 3,
                               capture=True)
  with pytest.raises(ValueError, match=r'feature store\)'):
    gtt.loader.DistScanTrainer(
        port_loader(2, np.arange(16), bucket_frac=None), model, 3,
        capture=True)
  full = port_loader(2, np.arange(16), dict(bucket_frac=None),
                     bucket_frac=None)
  with pytest.raises(ValueError, match='CUDA device'):
    gtt.loader.DistScanTrainer(full, model, 3, capture=True)
  t = gtt.loader.DistScanTrainer(port_loader(2, np.arange(16)), model, 3)
  assert t.capture is False
