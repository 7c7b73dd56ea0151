"""The port's serving tier against the JAX package.

The segment ``SAGEConv`` / ``GraphSAGE`` forward and its layer slices,
``padded_neighbors``, the full-graph ``EmbeddingMaterializer`` and its
final-layer ``refresh_rows``, the ``EmbeddingStore`` lookup (routed
through gather v2 and not), the ``ServingEngine`` (exactly-once answers,
no padding leak, stale marks kept across a failed refresh) and the
metric registry's percentiles. Inputs come from numpy seeds and go
through both packages, with the flax weights carried across by
``models.convert``. Float outputs agree within atol 1e-5, rtol 1e-4 (the
two frameworks sum in other orders); ids, tables of ids and lookups are
exact. The graph is the 90-node fixture of tests/test_serving.py: degree
skew, a zero-out-degree node, a ragged last block at any power-of-two
block size.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu import metrics as jmetrics
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import conv as jconv
from graphlearn_tpu.serving import EmbeddingMaterializer as JaxMaterializer
from graphlearn_tpu.serving import EmbeddingStore as JaxStore
from graphlearn_tpu.serving import ServingEngine as JaxEngine
from graphlearn_tpu.serving import padded_neighbors as jax_padded_neighbors
from graphlearn_tpu_torch import metrics, ops
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                          EmbeddingStore, ServingEngine,
                                          padded_neighbors)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F = 90, 6
TOL = dict(atol=1e-5, rtol=1e-4)


def _graph(n=N, f=F, seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(n - 1), 4)        # node n-1: zero out-degree
  cols = (rows + rng.integers(1, n, rows.shape[0])) % n
  rows = np.concatenate([rows, np.full(12, 3)])  # hub: degree 16
  cols = np.concatenate([cols, rng.integers(0, n, 12)])
  feats = rng.standard_normal((n, f)).astype(np.float32)
  labels = rng.integers(0, 3, n)
  return np.stack([rows, cols]), feats, labels


def _jax_dataset():
  ei, feats, labels = _graph()
  ds = glt.data.Dataset()
  ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  return ds


def _torch_dataset():
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  return ds


def _full_batch(topo, feats):
  """(x, edge_index, edge_mask) of the whole stored graph, message-flow
  orientation (row = stored neighbour = source, col = stored key)."""
  key = np.repeat(np.arange(topo.indptr.shape[0] - 1), np.diff(topo.indptr))
  ei = np.stack([np.asarray(topo.indices, np.int64), key]).astype(np.int32)
  return feats, ei, np.ones(ei.shape[1], bool)


def _torch_sage(params, hidden, out, layers, in_dim=F):
  model = gtt.models.GraphSAGE(in_dim, hidden, out, num_layers=layers,
                               device='cpu')
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  return model.eval()


def _tb(x, ei, em):
  return dict(x=torch.as_tensor(np.asarray(x)),
              edge_index=torch.as_tensor(np.asarray(ei)),
              edge_mask=torch.as_tensor(np.asarray(em)))


@pytest.fixture(scope='module')
def ref():
  """One JAX materialization (block 16, chunk 4: a ragged tail block and
  a tail chunk) and its port twin, 3 layers, hidden 8, out 3."""
  jds = _jax_dataset()
  x, ei, em = _full_batch(jds.graph.topo, jds.node_features.feature_array)
  jmodel = JaxSAGE(hidden_dim=8, out_dim=3, num_layers=3)
  params = jmodel.init(jax.random.PRNGKey(0), x, ei, em)
  direct = np.asarray(jmodel.apply(params, x, ei, em))
  jmat = JaxMaterializer(jds, jmodel, params, block_size=16, chunk_size=4)
  jemb = np.asarray(jmat.materialize())
  stale = np.array([0, 3, 41, 89])
  jrefresh = jmat.refresh_rows(stale)
  model = _torch_sage(params, 8, 3, 3)
  tds = _torch_dataset()
  tmat = EmbeddingMaterializer(tds, model, block_size=16, chunk_size=4)
  temb = tmat.materialize().numpy()
  return dict(jds=jds, tds=tds, jmodel=jmodel, params=params, model=model,
              batch=(x, ei, em), direct=direct, jmat=jmat, jemb=jemb,
              tmat=tmat, temb=temb, stale=stale, jrefresh=jrefresh)


# ------------------------------------------------------------ the models


@pytest.mark.parametrize('aggr', ['mean', 'sum', 'max'])
def test_sage_conv_matches_flax(aggr):
  """Masked edges, -1 sources and targets, and an isolated node."""
  rng = np.random.default_rng(1)
  n, e = 25, 90
  x = rng.standard_normal((n, 7)).astype(np.float32)
  ei = np.stack([rng.integers(0, n - 1, e),
                 rng.integers(0, n - 1, e)]).astype(np.int32)
  ei[0, :5] = -1
  ei[1, 5:9] = -1
  em = rng.random(e) < 0.8
  jconv_mod = jconv.SAGEConv(5, aggr=aggr)
  params = jconv_mod.init(jax.random.PRNGKey(2), x, ei, em)
  want = np.asarray(jconv_mod.apply(params, x, ei, em))
  conv = gtt.models.SAGEConv(7, 5, aggr=aggr)
  p = jax.tree.map(np.asarray, params)['params']
  conv.load_state_dict({
      'lin_self.weight': torch.as_tensor(p['lin_self']['kernel'].T.copy()),
      'lin_self.bias': torch.as_tensor(p['lin_self']['bias'].copy()),
      'lin_nbr.weight': torch.as_tensor(p['lin_nbr']['kernel'].T.copy())})
  with torch.no_grad():
    got = conv(*_tb(x, ei, em).values()).numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_segment_graphsage_matches_flax(ref):
  """The full-graph segment forward, 3 layers, with masked edges and the
  zero-degree node; the weights round-trip through params_to_flax."""
  x, ei, em = ref['batch']
  em = em.copy()
  em[::7] = False
  want = np.asarray(ref['jmodel'].apply(ref['params'], x, ei, em))
  with torch.no_grad():
    got = ttrain.make_forward_fn(ref['model'])(_tb(x, ei, em)).numpy()
  np.testing.assert_allclose(got, want, **TOL)
  back = convert.params_to_flax(ref['model'].state_dict())
  flat = jax.tree.map(np.asarray, ref['params'])
  jax.tree.map(np.testing.assert_array_equal, back, flat)


def test_layer_slices_compose_to_the_full_forward(ref):
  """make_layer_slice_fn slices [i, i+1) compose back to the full
  forward (ReLU after every layer but the last), and each slice equals
  the flax slice."""
  x, ei, em = ref['batch']
  model = ref['model']
  with torch.no_grad():
    full = ttrain.make_forward_fn(model)(_tb(x, ei, em)).numpy()
    h, jh = torch.as_tensor(x), x
    for i in range(3):
      b = _tb(x, ei, em)
      b['x'] = h
      h = ttrain.make_layer_slice_fn(model, i, i + 1)(b)
      jh = glt.models.train.make_layer_slice_fn(ref['jmodel'], i, i + 1)(
          ref['params'], dict(x=jh, edge_index=ei, edge_mask=em))
      np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
      if i < 2:
        assert bool((h >= 0).all())           # post-ReLU stores
  np.testing.assert_allclose(full, h.numpy(), rtol=1e-5)
  with pytest.raises(AssertionError):
    model(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em),
          layers=(2, 4))


# --------------------------------------------------------- materializer


@pytest.mark.parametrize('cap', [None, 2])
def test_padded_neighbors_matches_jax(ref, cap):
  want = jax_padded_neighbors(ref['jds'].graph.topo, cap)
  got = padded_neighbors(ref['tds'].graph.topo, cap)
  np.testing.assert_array_equal(got, want)
  assert got.dtype == np.int32 and got.shape[1] == (cap or 16)


def test_materialize_matches_jax_and_the_direct_forward(ref):
  temb, jemb = ref['temb'], ref['jemb']
  assert temb.shape == jemb.shape == (96, 3)
  np.testing.assert_allclose(temb[:N], jemb[:N], **TOL)
  np.testing.assert_allclose(temb[:N], ref['direct'], **TOL)
  assert ref['tmat'].embedding_store().num_nodes == N


def test_materialize_neighbor_cap_matches_jax(ref):
  """neighbor_cap=2 truncates heavier nodes (approximate serving) the
  same way in both packages."""
  jmat = JaxMaterializer(ref['jds'], ref['jmodel'], ref['params'],
                         block_size=32, chunk_size=2, neighbor_cap=2)
  want = np.asarray(jmat.materialize())
  tmat = EmbeddingMaterializer(ref['tds'], ref['model'], block_size=32,
                               chunk_size=2, neighbor_cap=2)
  got = tmat.materialize().numpy()
  np.testing.assert_allclose(got[:N], want[:N], **TOL)
  assert not np.allclose(got[:N], ref['temb'][:N], atol=1e-3)


def test_refresh_rows_matches_jax(ref):
  got = ref['tmat'].refresh_rows(ref['stale'])
  np.testing.assert_allclose(got, ref['jrefresh'], **TOL)
  np.testing.assert_allclose(got, ref['direct'][ref['stale']], **TOL)
  assert ref['tmat'].refresh_rows(np.zeros((0,))).shape == (0, 3)


def test_materializer_refuses_other_models(ref):
  no, eo = gtt.sampler.tree_layout(4, [2])
  layered = gtt.models.GraphSAGE(F, 8, 3, num_layers=1, hop_node_offsets=no,
                                 hop_edge_offsets=eo, tree_dense=True,
                                 fanouts=[2], device='cpu')
  with pytest.raises(ValueError, match='GraphSAGE'):
    EmbeddingMaterializer(ref['tds'], layered)
  with pytest.raises(ValueError, match='Linear'):
    EmbeddingMaterializer(ref['tds'], torch.nn.Linear(3, 3))
  with pytest.raises(RuntimeError, match='materialize'):
    EmbeddingMaterializer(ref['tds'], ref['model']).refresh_rows([1])


# ---------------------------------------------------------------- store


def test_store_lookup_routed_and_plain_agree():
  """Routed through gather v2 (the CPU route is its plain version) and
  plain indexing both give table[ids] with pad slots zeroed; no kernel
  launches on CPU tensors; update_rows writes only the real rows."""
  rng = np.random.default_rng(5)
  table = rng.standard_normal((40, 47)).astype(np.float32)
  store = EmbeddingStore(torch.as_tensor(table.copy()), num_nodes=37)
  ids = np.full(16, -1, np.int32)
  ids[:11] = [3, 4, 5, 6, 7, 8, 9, 10, 36, 0, 3]
  mask = ids >= 0
  want = np.where(mask[:, None], table[np.maximum(ids, 0)], 0)
  ops.reset_launch_counts()
  plain = store.fetch(store.lookup(ids, mask))
  store.set_kernel_routing(use_pallas_v2=True, block_rows=8, run_span=4)
  routed = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(plain, want)
  np.testing.assert_array_equal(routed, want)
  assert sum(ops.launch_counts().values()) == 0
  store.update_rows(np.array([4, 36]), np.full((2, 47), 7.0, np.float32))
  store.update_rows(np.zeros((0,), np.int64), np.zeros((0, 47)))
  t = store.table.numpy()
  assert (t[[4, 36]] == 7.0).all()
  np.testing.assert_array_equal(np.delete(t, [4, 36], 0),
                                np.delete(table, [4, 36], 0))


@pytest.mark.parametrize('routed', [False, True])
def test_store_lookup_out_of_range_matches_jax(routed):
  """Ids past the padded table, -1 pads and valid ids: the port's store
  (plain and routed through gather v2) answers the JAX store's rows (an
  id past the table reads the last row, as the JAX gather clamps it),
  without raising."""
  rng = np.random.default_rng(6)
  table = rng.standard_normal((40, 47)).astype(np.float32)
  ids = np.array([40, -1, 5, 1000, 39, 0, -1, 41], np.int32)
  mask = np.array([True, False, True, True, True, True, False, True])
  jstore = JaxStore(table.copy(), num_nodes=37)
  store = EmbeddingStore(torch.as_tensor(table.copy()), num_nodes=37)
  store.set_kernel_routing(use_pallas_v2=routed, block_rows=8, run_span=4)
  want = jstore.fetch(jstore.lookup(ids, mask))
  got = store.fetch(store.lookup(ids, mask))
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got[[0, 3, 7]], table[[39, 39, 39]])


# ---------------------------------------------------------------- engine


def _served(num_layers=2, block=32):
  """A port materialization (2 layers, hidden 8, out 4, block 32: pad
  rows 90..95) and the port's direct full forward."""
  tds = _torch_dataset()
  gen = torch.Generator().manual_seed(0)
  model = gtt.models.GraphSAGE(F, 8, 4, num_layers=num_layers,
                               device='cpu', generator=gen).eval()
  mat = EmbeddingMaterializer(tds, model, block_size=block, chunk_size=4)
  emb = mat.materialize().numpy().copy()
  x, ei, em = _full_batch(tds.graph.topo, _graph()[1])
  with torch.no_grad():
    direct = ttrain.make_forward_fn(model)(_tb(x, ei, em)).numpy()
  return mat, emb, direct


def test_bucket_admission_property():
  """60 concurrent variable-length requests from 6 threads, routed
  through gather v2: each answered exactly once with its own rows in its
  own order, no padding leak; out-of-range ids rejected."""
  mat, emb, _ = _served()
  store = mat.embedding_store()
  store.set_kernel_routing(use_pallas_v2=True, block_rows=16, run_span=4)
  base = metrics.snapshot()['counters'].get('serving.requests', 0)
  rng = np.random.default_rng(7)
  reqs = [rng.integers(0, N, rng.integers(1, 50)) for _ in range(60)]
  results = [None] * len(reqs)
  with ServingEngine(store, buckets=(16, 64), max_wait_ms=1.0) as engine:
    engine.lookup(np.arange(5))      # cap 16
    engine.lookup(np.arange(40))     # cap 64

    def client(lo, hi):
      for i in range(lo, hi):
        results[i] = engine.submit(reqs[i]).result(30)

    threads = [threading.Thread(target=client, args=(k * 10, k * 10 + 10))
               for k in range(6)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(60)
    assert not any(t.is_alive() for t in threads)
  for ids, res in zip(reqs, results):
    assert res.shape == (ids.size, 4)         # padding never leaks
    np.testing.assert_array_equal(res, emb[ids])
  snap = metrics.snapshot()
  assert snap['counters']['serving.requests'] - base == len(reqs) + 2
  with ServingEngine(store, buckets=(16,)) as eng2:
    with pytest.raises(ValueError, match='padding'):
      eng2.submit([N])                # a block-padding row of the table
    with pytest.raises(ValueError, match='padding'):
      eng2.submit([-1])
    assert eng2.lookup([]).shape == (0, 4)
  with pytest.raises(RuntimeError, match='not started'):
    eng2.submit([1])


def test_serving_engine_histograms_and_refresh():
  """Lookups, then poisoned rows marked stale: the next lookup serves
  the final-layer recompute exactly once, and the serving.* histograms
  carry every request."""
  mat, emb, direct = _served()
  metrics.reset('serving')
  store = mat.embedding_store()
  assert store.num_nodes == N
  engine = ServingEngine(store, buckets=(8, 32), max_wait_ms=1.0,
                         refresh_fn=mat.refresh_rows)
  with engine:
    for _ in range(10):
      out = engine.lookup(np.arange(7))
    np.testing.assert_array_equal(out, emb[:7])
    stale = np.array([2, 5])
    store.update_rows(stale, np.full((2, 4), 1e9, np.float32))
    engine.mark_stale(stale)
    assert engine.stale_count() == 2
    fresh = engine.lookup(stale)
    np.testing.assert_allclose(fresh, direct[stale], **TOL)
    assert engine.stale_count() == 0
  snap = metrics.snapshot()
  assert snap['counters']['serving.refreshed'] == 2
  assert snap['counters']['serving.batches'] >= 11
  for h in ('serving.queue_wait_ms', 'serving.batch_fill',
            'serving.compute_ms', 'serving.total_ms'):
    assert snap['histograms'][h]['count'] >= 10, h
  pct = metrics.histogram('serving.total_ms').percentiles()
  assert 0 <= pct['p50'] <= pct['p99']
  with pytest.raises(ValueError, match='refresh_fn'):
    ServingEngine(store).mark_stale([1])


def test_refresh_failure_keeps_stale_mark():
  mat, _, direct = _served()
  boom = []

  def flaky_refresh(ids):
    if not boom:
      boom.append(1)
      raise RuntimeError('transient refresh failure')
    return mat.refresh_rows(ids)

  store = mat.embedding_store()
  with ServingEngine(store, buckets=(8,), max_wait_ms=1.0,
                     refresh_fn=flaky_refresh) as engine:
    store.update_rows(np.array([4]), np.full((1, 4), 1e9, np.float32))
    engine.mark_stale([4])
    with pytest.raises(RuntimeError, match='transient'):
      engine.lookup([4])
    assert engine.stale_count() == 1      # the mark survived the failure
    np.testing.assert_allclose(engine.lookup([4]), direct[[4]], **TOL)
    assert engine.stale_count() == 0


def test_serving_slice_end_to_end_matches_jax(ref):
  """One request set through the port's engine (routed through gather
  v2, with a refresh) and the JAX engine, over stores materialized from
  the same graph and weights."""
  rng = np.random.default_rng(11)
  reqs = [rng.integers(0, N, rng.integers(1, 70)) for _ in range(12)]
  reqs.append(np.arange(20, 60))           # runs for the plan
  jstore = JaxStore(ref['jemb'].copy(), num_nodes=N)
  tstore = EmbeddingStore(torch.as_tensor(ref['temb'].copy()),
                          num_nodes=N)
  tstore.set_kernel_routing(use_pallas_v2=True, block_rows=16, run_span=4)
  outs = {}
  for name, engine in (
      ('jax', JaxEngine(jstore, buckets=(16, 64), max_wait_ms=1.0,
                        refresh_fn=ref['jmat'].refresh_rows)),
      ('torch', ServingEngine(tstore, buckets=(16, 64), max_wait_ms=1.0,
                              refresh_fn=ref['tmat'].refresh_rows))):
    with engine:
      got = [engine.lookup(r) for r in reqs]
      engine.store.update_rows(ref['stale'],
                               np.full((4, 3), 1e9, np.float32))
      engine.mark_stale(ref['stale'])
      got.append(engine.lookup(np.concatenate([ref['stale'], [7]])))
    outs[name] = got
  for a, b in zip(outs['torch'], outs['jax']):
    np.testing.assert_allclose(a, b, **TOL)
  np.testing.assert_allclose(outs['torch'][-1][:4],
                             ref['direct'][ref['stale']], **TOL)


# --------------------------------------------------------------- metrics


def test_metrics_percentiles_match_jax():
  """The port's registry bins, merges and estimates percentiles exactly
  as the JAX package's on the same observations."""
  rng = np.random.default_rng(3)
  vals = np.concatenate([rng.lognormal(0.0, 1.5, 500), [0.0, -1.0, 1e12]])
  treg, jreg = metrics.MetricRegistry(), jmetrics.MetricRegistry()
  for v in vals:
    treg.observe('serving.total_ms', v)
    jreg.observe('serving.total_ms', v)
  treg.inc('serving.requests', 3)
  jreg.inc('serving.requests', 3)
  assert metrics.HIST_BOUNDS == jmetrics.HIST_BOUNDS
  assert metrics.BUCKET_SCHEMA == jmetrics.BUCKET_SCHEMA
  th, jh = treg.histogram('serving.total_ms'), jreg.histogram(
      'serving.total_ms')
  assert th.percentiles() == jh.percentiles()
  for q in (0.0, 0.1, 0.5, 0.9, 0.999, 1.0):
    assert th.quantile(q) == jh.quantile(q)
  assert treg.snapshot() == jreg.snapshot()
  merged = metrics.merge_snapshots([treg.snapshot(), jreg.snapshot()])
  assert merged == jmetrics.merge_snapshots([jreg.snapshot()] * 2)
  assert metrics.quantile_from_state(
      merged['histograms']['serving.total_ms'], 0.5) == jh.quantile(0.5)
  with pytest.raises(ValueError, match='one name, one type'):
    treg.gauge('serving.requests')
