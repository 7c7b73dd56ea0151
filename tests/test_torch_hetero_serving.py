"""The port's typed (RGNN) materializer, refresh and engine against the
JAX package's, on the CPU.

tests/test_serving.py:147-240 on both packages: the same typed dataset,
the same RGNN weights (``models.convert``), the same block and chunk
sizes. Every pass's store (the per-type input projections, each conv
layer's per-type stores, the head's table) is held to JAX's, and so are
the refreshed rows of ``refresh_rows(ids, ntype=)``, within atol 1e-5 /
rtol 1e-4; the typed refresh's errors, its empty bucket, the engine's
``mark_stale`` path over a poisoned row, and the spill files (JAX's
names, each package's ``DiskTier`` reading the other's).
"""
import os

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import RGNN as JRGNN
from graphlearn_tpu.serving import EmbeddingMaterializer as JMat
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.serving import (EmbeddingMaterializer,
                                          EmbeddingStore, ServingEngine)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
ATOL, RTOL = 1e-5, 1e-4
rev = gtt.typing.reverse_edge_type


def typed_data(n_p=40, n_a=24, seed=3):
  """tests/test_serving.py's typed dataset (papers cite papers, authors
  write papers; an isolated author tail) in both packages."""
  rng = np.random.default_rng(seed)
  pr = rng.integers(0, n_p, 4 * n_p)
  pc = rng.integers(0, n_p, 4 * n_p)
  ar = np.repeat(np.arange(n_a - 2), 3)
  ap = rng.integers(0, n_p, ar.size)
  edges = {CITES: np.stack([pr, pc]), WRITES: np.stack([ar, ap])}
  nodes = {CITES: n_p, WRITES: n_a}
  feats = {'paper': rng.standard_normal((n_p, 8)).astype(np.float32),
           'author': rng.standard_normal((n_a, 8)).astype(np.float32)}
  jds = glt.data.Dataset()
  jds.init_graph(edges, graph_mode='CPU', num_nodes=nodes)
  jds.init_node_features(feats)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(edges, num_nodes=nodes)
  ds.init_node_features(feats)
  return jds, ds


def full_batch(jds):
  """The whole graph as one typed batch in the samplers' message-flow
  orientation (tests/test_serving.py:hetero_full_batch)."""
  eid, emd = {}, {}
  for et in (CITES, WRITES):
    topo = jds.graph[et].topo
    key = np.repeat(np.arange(topo.indptr.shape[0] - 1),
                    np.diff(topo.indptr))
    eid[rev(et)] = np.stack([topo.indices.astype(np.int64),
                             key]).astype(np.int32)
    emd[rev(et)] = np.ones(eid[rev(et)].shape[1], bool)
  return ({t: f.feature_array for t, f in jds.node_features.items()},
          eid, emd)


def models(conv, out_ntype='paper', heads=1, hidden=8):
  """The JAX RGNN with initialised parameters and the port's RGNN
  holding the same weights."""
  jds, ds = typed_data()
  etypes = (rev(CITES), rev(WRITES))
  jm = JRGNN(etypes=etypes, hidden_dim=hidden, out_dim=4, num_layers=2,
             conv=conv, heads=heads, out_ntype=out_ntype)
  params = jm.init(jax.random.PRNGKey(0), *full_batch(jds))
  tm = gtt.models.RGNN(etypes, {'paper': 8, 'author': 8}, hidden, 4,
                       num_layers=2, conv=conv, heads=heads,
                       out_ntype=out_ntype, device='cpu')
  tm.load_state_dict(convert.params_from_flax(params, tm), strict=False)
  tm.eval()
  return jds, ds, jm, params, tm


def close(got, want):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


@pytest.fixture(scope='module', params=[('sage', 1), ('gat', 2)],
                ids=['rsage', 'rgat'])
def served(request, tmp_path_factory):
  """rsage, or a 2-head rgat: both packages' materializers (block 8, chunk
  8: one chunk a pass; spilled under a temporary directory each) after
  ``materialize()``, shared by the tests below (a JAX materializer
  compiles its programs per instance)."""
  conv, heads = request.param
  jds, ds, jm, params, tm = models(conv, heads=heads)
  root = tmp_path_factory.mktemp(f'spill_{conv}')
  jmat = JMat(jds, jm, params, block_size=8, chunk_size=8,
              spill_dir=str(root / 'jax'))
  jtable = jmat.materialize()
  mat = EmbeddingMaterializer(ds, tm, block_size=8, chunk_size=8,
                              spill_dir=str(root / 'port'))
  table = mat.materialize()
  return dict(conv=conv, jds=jds, ds=ds, jm=jm, params=params, tm=tm,
              jmat=jmat, jtable=jtable, mat=mat, table=table, root=root)


def test_hetero_materialized_stores_match_jax(served):
  """Every pass of the typed materialization equals JAX's: the head's
  table (and the direct full-graph forward), each conv layer's per-type
  stores and the store set before the last layer, for rsage and a
  2-head rgat; a block size that leaves ragged tails and runs one chunk
  a block gives the same table."""
  jmat, mat = served['jmat'], served['mat']
  got, want = served['table'], served['jtable']
  assert got.shape == tuple(want.shape)
  close(got, want)
  direct = np.asarray(served['jm'].apply(served['params'],
                                         *full_batch(served['jds'])))
  close(got[:40], direct)
  assert sorted(mat.stores) == sorted(jmat.stores) == ['author', 'paper']
  for t in jmat.stores:
    close(mat.stores[t], jmat.stores[t])
    close(mat._penultimate[t], jmat._penultimate[t])
  assert mat._w == jmat._w
  for et in jmat._nbr_np:
    np.testing.assert_array_equal(mat._nbr[et].numpy(), jmat._nbr_np[et])
  ragged = EmbeddingMaterializer(served['ds'], served['tm'], block_size=16,
                                 chunk_size=1).materialize()
  assert ragged.shape == (48, 4)
  close(ragged[:40], direct)


def test_hetero_materializer_without_head_matches_jax():
  """An RGNN without ``out_ntype``: the per-type stores are the result,
  equal to JAX's full-graph forward; a type's refresh gives its
  last-layer rows."""
  jds, ds, jm, params, tm = models('sage', out_ntype=None)
  want = jm.apply(params, *full_batch(jds))
  mat = EmbeddingMaterializer(ds, tm, block_size=8)
  got = mat.materialize()
  assert isinstance(got, dict) and sorted(got) == sorted(want)
  for t in want:
    close(got[t][:want[t].shape[0]], want[t])
  ids = np.array([1, 5, 23])
  close(mat.refresh_rows(ids, ntype='author'), np.asarray(got['author'])[ids])
  assert mat.refresh_rows([], ntype='author').shape == (0, 4)


def test_hetero_refresh_and_engine_match_jax(served):
  """tests/test_serving.py:test_hetero_final_layer_refresh_parity on the
  port: the typed refresh equals JAX's and the materialized rows, its
  errors are JAX's, the empty bucket is ``[0, out_dim]``, and the engine
  serves a poisoned row fresh through ``mark_stale``."""
  jmat, mat, table = served['jmat'], served['mat'], served['table']
  ids = np.array([0, 3, 17, 39])
  rows = mat.refresh_rows(ids, ntype='paper')
  close(rows, jmat.refresh_rows(ids, ntype='paper'))
  close(rows, table[ids])
  # a bucket of authors (no head: their last conv layer's rows)
  aids = np.array([0, 7, 21, 22, 23])
  close(mat.refresh_rows(aids, ntype='author'),
        jmat.refresh_rows(aids, ntype='author'))
  close(mat.refresh_rows(aids, ntype='author'), mat.stores['author'][aids])
  for m in (jmat, mat):
    with pytest.raises(ValueError, match='ntype'):
      m.refresh_rows(ids)
    with pytest.raises(ValueError, match='final-layer store'):
      m.refresh_rows(ids, ntype='nope')
    assert m.refresh_rows(np.zeros((0,)), ntype='paper').shape == (0, 4)
  # a type no edge type feeds in the last layer (here: authors, once the
  # papers they read have no store before it)
  saved = mat._penultimate, jmat._penultimate
  mat._penultimate = {'author': saved[0]['author']}
  jmat._penultimate = {'author': saved[1]['author']}
  try:
    with pytest.raises(ValueError, match='receives no messages'):
      jmat._hetero_refresh_fn_for('author', 16)
    with pytest.raises(ValueError, match='receives no messages'):
      mat._hetero_refresh('author', torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.bool))
  finally:
    mat._penultimate, jmat._penultimate = saved
  # the engine: a poisoned row served fresh through the typed refresh
  store = EmbeddingStore(table.clone(), num_nodes=40, device='cpu')
  engine = ServingEngine(store, buckets=(16,), max_wait_ms=0.5,
                         refresh_fn=lambda i: mat.refresh_rows(
                             i, ntype='paper'))
  store.update_rows(np.array([17]), np.full((1, 4), 1e9, np.float32))
  engine.mark_stale([17])
  with engine:
    out = engine.lookup(np.array([17, 3]))
  direct = np.asarray(served['jm'].apply(served['params'],
                                         *full_batch(served['jds'])))
  close(out, direct[[17, 3]])
  assert engine.stale_count() == 0


def test_hetero_spill_names_and_tiers_cross_read(served):
  """With ``spill_dir`` every pass lands under JAX's label (``embed/{t}``,
  ``{layer}/{t}``, ``head/{t}``, files ``pass_embed_paper`` ...), equal
  to JAX's rows, and each package's ``DiskTier`` reads the other's
  files; the per-type stores are not wrapped as one store."""
  from graphlearn_tpu.storage import DiskTier as JTier
  from graphlearn_tpu_torch.storage import DiskTier as TTier
  jmat, mat = served['jmat'], served['mat']
  jdir, tdir = served['root'] / 'jax', served['root'] / 'port'
  labels = ['embed/author', 'embed/paper', '0/author', '0/paper',
            '1/author', '1/paper', 'head/paper']
  assert sorted(mat.spilled) == sorted(jmat.spilled) == sorted(labels)
  assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
  for label in labels:
    name = 'pass_' + label.replace('/', '_')
    jt, tt = JTier(str(jdir / name)), TTier(str(tdir / name))
    assert tt.shape == jt.shape
    ids = np.arange(jt.shape[0])
    close(tt.gather(ids), jt.gather(ids))
    # each package reads the other's tier
    close(TTier(str(jdir / name)).gather(ids), JTier(str(tdir / name)
                                                     ).gather(ids))
  with pytest.raises(ValueError, match='per-type'):
    mat.embedding_store()
  with pytest.raises(ValueError, match='per-type'):
    mat.tiered_embedding_store()


def test_hetero_materializer_checks_its_inputs():
  """JAX's checks: an RGNN over a typed dataset, per-type features, a
  key type with features; and the port's: the segment RGNN only."""
  jds, ds, jm, params, tm = models('sage')
  sage = gtt.models.GraphSAGE(8, 8, 4, num_layers=2, device='cpu')
  with pytest.raises(ValueError, match='covers RGNN'):
    EmbeddingMaterializer(ds, sage)
  bare = gtt.data.Dataset(device='cpu')
  bare.graph = ds.graph
  with pytest.raises(ValueError, match='per-type features'):
    EmbeddingMaterializer(bare, tm)
  part = gtt.data.Dataset(device='cpu')
  part.graph = ds.graph
  part.node_features = {'paper': ds.node_features['paper']}
  with pytest.raises(ValueError, match='has no features'):
    EmbeddingMaterializer(part, tm)
  dense = gtt.models.RGNN(
      (rev(CITES), rev(WRITES)), {'paper': 8, 'author': 8}, 8, 4,
      out_ntype='paper', hop_node_offsets={'paper': (8, 16, 24),
                                           'author': (0, 8, 16)},
      hop_edge_offsets={rev(CITES): (8, 16), rev(WRITES): (8, 16)},
      device='cpu')
  with pytest.raises(ValueError, match='segment forward'):
    EmbeddingMaterializer(ds, dense)


def test_layer_slice_fn_forwards_rgnn_keywords():
  """``make_layer_slice_fn(model, lo, hi, **fixed)``: the embed slice,
  the conv layers and the head slice compose to the full forward, as
  JAX's slices do."""
  from graphlearn_tpu.models import train as jtrain
  from graphlearn_tpu_torch.models import train as ttrain
  jds, ds, jm, params, tm = models('sage')
  xd, eid, emd = full_batch(jds)
  tb = dict(x={t: torch.as_tensor(v) for t, v in xd.items()},
            edge_index={et: torch.as_tensor(v) for et, v in eid.items()},
            edge_mask={et: torch.as_tensor(v) for et, v in emd.items()})
  jb = dict(x=xd, edge_index=eid, edge_mask=emd)
  with torch.no_grad():
    h = ttrain.make_layer_slice_fn(tm, 0, 0, embed=True, head=False)(tb)
    jh = jtrain.make_layer_slice_fn(jm, 0, 0, embed=True, head=False)(
        params, jb)
    for t in jh:
      close(h[t], jh[t])
    h = ttrain.make_layer_slice_fn(tm, 0, 2, embed=False, head=False)(
        dict(tb, x=h))
    out = ttrain.make_layer_slice_fn(tm, 2, 2, embed=False, head=True)(
        dict(tb, x=h))
  close(out, jm.apply(params, xd, eid, emd))
