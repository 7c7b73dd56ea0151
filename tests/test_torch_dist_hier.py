"""The port's 2-axis (slice, chip) mesh against the JAX package's on the
CPU.

``init_worker_group(mesh_shape=(S, C))`` lays the P = S * C shards out
as S slices of C chips (partition ``s * C + c``) and the samplers and
the feature store take the hierarchical two-stage exchange: full width
along 'chip', ``[S, cap2]`` buckets along 'slice', the flat full-width
exchange when a fractional ``cap2`` overflows. JAX runs its programs on
a ``('slice', 'chip')`` mesh of the conftest's CPU devices; the port the
same exchange on a one-process ``ShardMesh(shape=(S, C))``. The
hierarchical draw differs from the flat one (requests reach the owner
in another slot order), so the port is held against JAX's hierarchical
path, never against flat. Held exactly: ``ShardMesh.all_to_all`` along
each axis against a numpy transpose, node and link batches on (2, 2) and
(4, 2) meshes (``bucket_frac`` 2.0, None and a fallback-forcing 0.5 on a
skewed book, with the counted verdicts), ``DistFeature.get`` through the
cache and the stage-2 fallback, the hierarchical ``DistEmbeddingStore``
and the scanned epoch against the port's per-step loop. Within atol 1e-5
/ rtol 1e-4: the 2-axis ``DistScanTrainer``'s losses and parameters
against JAX's.
"""
import copy

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.sampler import EdgeSamplerInput as JEdge
from graphlearn_tpu.sampler import NegativeSampling as JNeg
from graphlearn_tpu.typing import GraphPartitionData as JPart
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.sampler import EdgeSamplerInput as TEdge
from graphlearn_tpu_torch.sampler import NegativeSampling as TNeg
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart

from test_torch_dist_link import assert_link_equal
from test_torch_distributed import N, _np, graphs, random_graph, ring
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask',
          'num_sampled_nodes', 'num_sampled_edges')


def jmesh2(shape):
  import jax
  from jax.sharding import Mesh
  p = shape[0] * shape[1]
  return Mesh(np.array(jax.devices()[:p]).reshape(shape), ('slice', 'chip'))


def tmesh2(shape):
  return gdist.ShardMesh(shape[0] * shape[1], 'cpu', shape=shape)


def _eq(a, b, what):
  a, b = np.asarray(a), _np(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  np.testing.assert_array_equal(a, b, err_msg=what)


def test_axis_all_to_all_is_the_axis_transpose():
  s, c = 2, 3
  mesh = tmesh2((s, c))
  assert mesh.axis_names == ('slice', 'chip')
  x = torch.arange(s * c * c * 2).reshape(s * c, c, 2)
  got = mesh.all_to_all(x, 'chip').numpy()
  xn = x.numpy().reshape(s, c, c, 2)
  for si in range(s):
    for a in range(c):
      for b in range(c):
        np.testing.assert_array_equal(got[si * c + a, b], xn[si, b, a])
  y = torch.arange(s * c * s * 2).reshape(s * c, s, 2)
  got = mesh.all_to_all(y, 'slice').numpy()
  yn = y.numpy().reshape(s, c, s, 2)
  for a in range(s):
    for ci in range(c):
      for b in range(s):
        np.testing.assert_array_equal(got[a * c + ci, b], yn[b, ci, a])
  ctx = gdist.init_worker_group(num_partitions=6, devices='cpu',
                                mesh_shape=(2, 3))
  assert ctx.mesh.shape == (2, 3)
  with pytest.raises(ValueError, match='mesh_shape'):
    gdist.init_worker_group(num_partitions=6, devices='cpu',
                            mesh_shape=(4, 2))


def skewed(p):
  """Every node (and edge) on partition 0."""
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  raw = [(np.stack([rows, cols]), np.arange(2 * N), None)]
  raw += [(np.zeros((2, 0), np.int64), np.zeros((0,), np.int64), None)
          for _ in range(p - 1)]
  feats = [(np.arange(N), np.arange(N, dtype=np.float32)[:, None] *
            np.ones((1, 4), np.float32))]
  feats += [(np.zeros(0, np.int64), np.zeros((0, 4), np.float32))
            for _ in range(p - 1)]
  return raw, feats, np.zeros(N, np.int32), None


HIER_CASES = [
    ((2, 2), 'ring', dict()),
    ((2, 2), 'rand', dict(bucket_frac=None, with_edge=True)),
    ((4, 2), 'ring', dict(dedup='tree', with_edge=True)),
    ((4, 2), 'skew', dict(bucket_frac=0.5)),
]


@pytest.mark.parametrize('shape,graph,kw', HIER_CASES)
def test_hier_sample_from_nodes_equals_jax(shape, graph, kw):
  p = shape[0] * shape[1]
  fixture = {'ring': lambda: ring(p), 'rand': lambda: random_graph(p),
             'skew': lambda: skewed(p)}[graph]()
  jg, tg = graphs(fixture)
  js = glt.distributed.DistNeighborSampler(jg, [2, 2], jmesh2(shape),
                                           seed=2, **kw)
  ts = gdist.DistNeighborSampler(tg, [2, 2], tmesh2(shape), seed=2, **kw)
  n = fixture[2].shape[0]
  gdist.reset_verdict_syncs()
  for it in range(2):
    seeds = np.random.default_rng(it).permutation(n)[:p * 4].reshape(
        p, 4).astype(np.int32)
    jo = js.sample_from_nodes(seeds)
    to = ts.sample_from_nodes(seeds)
    for f in FIELDS + (('edge',) if kw.get('with_edge') else ()):
      _eq(getattr(jo, f), getattr(to, f), f'{shape} {it} {f}')
  frac = kw.get('bucket_frac', 2.0)
  if frac is None:
    assert gdist.verdict_syncs() == 0
  elif graph == 'skew':
    assert gdist.verdict_syncs() > 0
  if graph == 'skew':
    em = to.edge_mask.numpy()
    assert (em.sum(1) >= 8).all()    # loss-free: 2 edges a seed at hop 1


def test_hier_link_batches_equal_jax():
  shape = (2, 2)
  jg, tg = graphs(ring(4))
  js = glt.distributed.DistNeighborSampler(jg, [2], jmesh2(shape), seed=5)
  ts = gdist.DistNeighborSampler(tg, [2], tmesh2(shape), seed=5)
  rows = (np.arange(8) * 3 % N).astype(np.int32).reshape(4, 2)
  cols = (rows + 1) % N
  for mode in ('binary', 'triplet'):
    assert_link_equal(
        js.sample_from_edges(JEdge(rows, cols, neg_sampling=JNeg(mode, 2))),
        ts.sample_from_edges(TEdge(rows, cols, neg_sampling=TNeg(mode, 2))),
        False, mode)


@pytest.mark.parametrize('shape,book,kw', [
    ((2, 2), 'ring', dict(split_ratio=0.25)),
    ((4, 2), 'ring', dict(split_ratio=1.0)),
    ((4, 2), 'skew', dict(bucket_frac=0.5))])
def test_hier_feature_get_equals_jax(shape, book, kw):
  """``tests/test_dist_feature_cache.py``'s hierarchical store: cached
  lookups and the skewed book's stage-2 fallback, rows and counters."""
  p = shape[0] * shape[1]
  _, feats, pb, _ = ring(p) if book == 'ring' else skewed(p)
  hot = np.arange(N)[::-1].copy() if 'split_ratio' in kw else None
  jf = glt.distributed.DistFeature(p, feats, pb, jmesh2(shape), hotness=hot,
                                   **kw)
  tf = gdist.DistFeature(p, feats, pb, tmesh2(shape), hotness=hot, **kw)
  gdist.reset_verdict_syncs()
  rng = np.random.default_rng(5)
  ids = rng.integers(-1, N, (p, 16)).astype(np.int32)
  _eq(jf.get(ids), tf.get(torch.as_tensor(ids)), 'rows')
  assert tf.stats() == jf.stats()
  if book == 'skew':
    assert tf.stats()['overflow'] > 0 and gdist.verdict_syncs() == 1


def test_hier_dist_embedding_store_serves_the_table():
  """``tests/test_serving.py``'s hierarchical ``DistEmbeddingStore``: the
  sharded store over a (2, 2) mesh serves the table's rows through the
  engine."""
  rng = np.random.default_rng(3)
  emb = torch.as_tensor(rng.standard_normal((96, 8)).astype(np.float32))
  store = gtt.serving.DistEmbeddingStore.build(emb, tmesh2((2, 2)),
                                               cache_rows=16, num_nodes=90)
  engine = gtt.serving.ServingEngine(store, buckets=(16,), max_wait_ms=1.0)
  with engine:
    ids = rng.integers(0, 90, 13)
    np.testing.assert_allclose(np.asarray(engine.lookup(ids)),
                               emb.numpy()[ids], rtol=1e-6)


# --------------------------------------------------------------- trainers

SHAPE = (2, 2)
SEEDS = np.arange(2, 30)          # 28 seeds, global batch 8: 4 steps


def _loader(side, **kw):
  p = SHAPE[0] * SHAPE[1]
  raw, feats, pb, epb = ring(p)
  if side == 'jax':
    mesh = jmesh2(SHAPE)
    g = glt.distributed.DistGraph(
        p, 0, [JPart(edge_index=e, eids=i) for e, i, _ in raw], pb, epb)
    f = glt.distributed.DistFeature(p, feats, pb, mesh, split_ratio=0.25)
    ds = glt.distributed.DistDataset(p, 0, g, f,
                                     node_labels=np.arange(N) % 3)
    return glt.distributed.DistNeighborLoader(
        ds, [2, 2], SEEDS, batch_size=2, seed=0, mesh=mesh,
        drop_last=False, **kw)
  mesh = tmesh2(SHAPE)
  fkw = dict(split_ratio=0.25)
  if 'bucket_frac' in kw:
    fkw['bucket_frac'] = kw['bucket_frac']
  g = gdist.DistGraph(p, 0, [TPart(edge_index=e, eids=i)
                             for e, i, _ in raw], pb, epb)
  f = gdist.DistFeature(p, feats, pb, mesh, **fkw)
  ds = gdist.DistDataset(p, 0, g, f, node_labels=np.arange(N) % 3)
  return gdist.DistNeighborLoader(ds, [2, 2], SEEDS, batch_size=2, seed=0,
                                  mesh=mesh, drop_last=False, **kw)


def port_model(params=None):
  model = gtt.models.GraphSAGE(4, 8, 3, num_layers=2, device='cpu',
                               generator=torch.Generator().manual_seed(0))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  return model


def test_hier_scanned_epoch_equals_jax():
  import jax
  import jax.numpy as jnp
  import optax
  from graphlearn_tpu.models import train as jtrain
  jm = glt.models.GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2)
  tx = optax.adam(1e-2)
  jl = _loader('jax', shuffle=True)
  jt = glt.loader.DistScanTrainer(jl, jm, tx, 3, chunk_size=2)
  first = next(iter(_loader('jax')))
  params = jm.init(jax.random.PRNGKey(0), np.asarray(first.x)[0],
                   np.asarray(first.edge_index)[0],
                   np.asarray(first.edge_mask)[0])
  jstate = jtrain.TrainState(params, tx.init(params), jnp.int32(0))
  model = port_model(jax.device_get(params))
  tt = gtt.loader.DistScanTrainer(_loader('port', shuffle=True), model, 3,
                                  chunk_size=2)
  state = gtt.models.create_train_state(model, lr=1e-2)
  jstate, jlosses, _ = jt.run_epoch(jstate)
  state, losses, _ = tt.run_epoch(state)
  np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
  want = convert.params_from_flax(jax.device_get(jstate.params))
  for name, v in model.state_dict().items():
    np.testing.assert_allclose(v.numpy(), want[name].numpy(), err_msg=name,
                               **TOL)


@pytest.mark.parametrize('frac', [None, 2.0])
def test_hier_scanned_epoch_equals_the_per_step_loop(frac):
  model_a = port_model()
  model_b = copy.deepcopy(model_a)
  la, lb = _loader('port', bucket_frac=frac), _loader('port',
                                                      bucket_frac=frac)
  ref = gtt.loader.DistFusedEpochTrainer(la, model_a, 3)
  trainer = gtt.loader.DistScanTrainer(lb, model_b, 3, chunk_size=3)
  sa = gtt.models.create_train_state(model_a, lr=1e-2)
  sb = gtt.models.create_train_state(model_b, lr=1e-2)
  gdist.reset_verdict_syncs()
  with published({0: la.sampler.dist_feature}) as stats_a:
    sa, losses_a = ref.run_epoch_steps(sa)
  syncs = gdist.verdict_syncs()
  gdist.reset_verdict_syncs()
  with published({0: lb.sampler.dist_feature}) as stats_b:
    sb, losses_b, _ = trainer.run_epoch(sb)
  assert gdist.verdict_syncs() == syncs
  assert (syncs == 0) == (frac is None)
  assert torch.equal(torch.stack(losses_a), losses_b)
  for x, y in zip(model_a.parameters(), model_b.parameters()):
    assert torch.equal(x, y)
  # each epoch published its store's counters once, at its end
  assert stats_a == stats_b and stats_a[0]['lookups'] > 0
