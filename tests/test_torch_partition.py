"""The port's partitioners and ``sample_prob`` against the JAX package's,
on the CPU.

tests/test_partition.py on both packages: the same inputs and seeds give
the same partition books (``node_pb``, ``edge_pb``), the same per-part
graph, feature and cache arrays and the same META; each package's
``load_partition`` reads the other's directory (``np.savez`` files are
not byte-equal between runs, so the loaded arrays are compared, not the
files). ``NeighborSampler.sample_prob`` agrees with JAX's within rtol
1e-5, and a ``FrequencyPartitioner`` fed the port's probabilities
partitions as JAX's fed its own.
"""
import json
import os

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu import partition as jpart
from graphlearn_tpu_torch import partition as tpart

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def ring_edges(n):
  rows = np.arange(n)
  return np.stack([rows, (rows + 1) % n])


def _eq(a, b, what):
  if a is None or b is None:
    assert a is None and b is None, what
    return
  a, b = np.asarray(a), np.asarray(b)
  assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
  np.testing.assert_array_equal(a, b, err_msg=what)


def assert_parts_equal(jdir, tdir, num_parts):
  """Every part of two partition directories loads to equal arrays, in
  both packages' loaders, and the META files are equal."""
  with open(os.path.join(jdir, 'META.json')) as f:
    jmeta = json.load(f)
  with open(os.path.join(tdir, 'META.json')) as f:
    assert json.load(f) == jmeta
  for p in range(num_parts):
    loads = [load(d, p) for load in (jpart.load_partition,
                                     tpart.load_partition)
             for d in (jdir, tdir)]
    ref = loads[0]
    for got in loads[1:]:
      assert got[0] == ref[0] == num_parts
      for i, name in ((1, 'graph'), (2, 'node_feat'), (3, 'edge_feat')):
        a, b = ref[i], got[i]
        if isinstance(a, dict):
          assert sorted(a) == sorted(b), name
          pairs = [(a[k], b[k], f'{name}/{k}') for k in a]
        else:
          pairs = [(a, b, name)]
        for x, y, what in pairs:
          if x is None:
            assert y is None, what
            continue
          for field in x._fields:
            _eq(getattr(x, field), getattr(y, field), f'{what}.{field}')
      for i, name in ((4, 'node_pb'), (5, 'edge_pb')):
        a, b = ref[i], got[i]
        if isinstance(a, dict):
          assert sorted(a) == sorted(b), name
          for k in a:
            _eq(a[k], b[k], f'{name}/{k}')
        else:
          _eq(a, b, name)


def test_random_partition_homo_matches_jax(tmp_path):
  """test_partition.py:test_random_partition_homo on both packages, with
  edge weights: equal directories, and JAX's checks on the port's."""
  n = 40
  ei = ring_edges(n)
  feat = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)
  efeat = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 2),
                                                            np.float32)
  w = np.linspace(0, 1, n, dtype=np.float32)
  for pkg, d in ((jpart, 'j'), (tpart, 't')):
    pkg.RandomPartitioner(str(tmp_path / d), 2, n, ei, node_feat=feat,
                          edge_feat=efeat, edge_weights=w, seed=0
                          ).partition()
  assert_parts_equal(str(tmp_path / 'j'), str(tmp_path / 't'), 2)
  num_parts, graph, nfeat, ef, node_pb, edge_pb = tpart.load_partition(
      str(tmp_path / 't'), 0)
  assert num_parts == 2
  assert abs((node_pb == 0).sum() - (node_pb == 1).sum()) <= 1
  assert (node_pb[graph.edge_index[0]] == 0).all()
  _, g1, _, _, _, _ = tpart.load_partition(str(tmp_path / 't'), 1)
  assert graph.eids.shape[0] + g1.eids.shape[0] == n
  np.testing.assert_allclose(nfeat.feats, feat[nfeat.ids])
  np.testing.assert_allclose(ef.feats, efeat[ef.ids])
  np.testing.assert_array_equal(graph.weights, w[graph.eids])
  assert (edge_pb[graph.eids] == 0).all()
  assert isinstance(graph, gtt.typing.GraphPartitionData)


@pytest.mark.parametrize('strategy', ['by_src', 'by_dst'])
def test_random_partition_hetero_matches_jax(tmp_path, strategy):
  """test_partition.py:test_random_partition_hetero on both packages,
  with per-type features, an edge type's features and weights, both edge
  assignment strategies and 3 parts."""
  et1, et2 = ('user', 'buys', 'item'), ('item', 'rev_buys', 'user')
  rng = np.random.default_rng(2)
  ei = {et1: np.stack([rng.integers(0, 30, 90), rng.integers(0, 12, 90)])}
  ei[et2] = ei[et1][::-1].copy()
  nfeat = {'user': rng.standard_normal((30, 3)).astype(np.float32),
           'item': rng.standard_normal((12, 3)).astype(np.float32)}
  efeat = {et1: rng.standard_normal((90, 2)).astype(np.float32)}
  w = {et1: rng.random(90).astype(np.float32),
       et2: rng.random(90).astype(np.float32)}
  for pkg, d in ((jpart, 'j'), (tpart, 't')):
    pkg.RandomPartitioner(str(tmp_path / d), 3, {'user': 30, 'item': 12},
                          ei, node_feat=nfeat, edge_feat=efeat,
                          edge_weights=w, edge_assign_strategy=strategy,
                          chunk_size=4, seed=5).partition()
  assert_parts_equal(str(tmp_path / 'j'), str(tmp_path / 't'), 3)
  _, graph, nf, ef, node_pb, edge_pb = tpart.load_partition(
      str(tmp_path / 't'), 0)
  assert set(node_pb) == {'user', 'item'}
  key = 0 if strategy == 'by_src' else 1
  own = 'user' if strategy == 'by_src' else 'item'
  assert (node_pb[own][graph[et1].edge_index[key]] == 0).all()
  np.testing.assert_allclose(nf['user'].feats,
                             nfeat['user'][nf['user'].ids])
  np.testing.assert_allclose(ef[et1].feats, efeat[et1][ef[et1].ids])


def test_frequency_partition_with_cache_matches_jax(tmp_path):
  """test_partition.py:test_frequency_partition_with_cache on both
  packages: equal books, parts and caches; JAX's checks on the port's."""
  n = 40
  ei = ring_edges(n)
  feat = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)
  p0 = np.zeros(n)
  p0[:20] = 1.0
  p1 = np.zeros(n)
  p1[20:] = 1.0
  for pkg, d in ((jpart, 'j'), (tpart, 't')):
    pkg.FrequencyPartitioner(str(tmp_path / d), 2, n, ei, probs=[p0, p1],
                             node_feat=feat, chunk_size=5,
                             cache_ratio=0.2).partition()
  assert_parts_equal(str(tmp_path / 'j'), str(tmp_path / 't'), 2)
  _, _, nfeat, _, node_pb, _ = tpart.load_partition(str(tmp_path / 't'), 0)
  assert (node_pb[:20] == 0).mean() > 0.9
  if nfeat.cache_ids is not None:
    assert (node_pb[nfeat.cache_ids] != 0).all()
    np.testing.assert_allclose(nfeat.cache_feats, feat[nfeat.cache_ids])


def test_cat_feature_cache_matches_jax():
  """test_partition.py:test_cat_feature_cache on both packages."""
  feats = np.arange(6, dtype=np.float32)[:, None]
  kw = dict(feats=feats, ids=np.array([10, 11, 12, 13, 14, 15]),
            cache_feats=np.array([[100.0], [101.0]]),
            cache_ids=np.array([3, 7]))
  pb = np.full(20, 1, dtype=np.int32)
  pb[[10, 11, 12, 13, 14, 15]] = 0
  want = jpart.cat_feature_cache(0, glt.typing.FeaturePartitionData(**kw),
                                 pb)
  got = tpart.cat_feature_cache(0, gtt.typing.FeaturePartitionData(**kw),
                                pb)
  for a, b in zip(want, got):
    _eq(a, b, 'cat_feature_cache')
  f, ids, new_pb = got
  np.testing.assert_array_equal(ids[:2], [3, 7])
  np.testing.assert_allclose(f[:2, 0], [100.0, 101.0])
  assert (new_pb[[3, 7]] == 0).all() and new_pb[4] == 1
  assert pb[3] == 1     # the input book is not changed
  empty = gtt.typing.FeaturePartitionData(feats, kw['ids'], None, None)
  assert tpart.cat_feature_cache(0, empty, pb)[2] is pb


def _graphs(n=300, e=2400, seed=0):
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  ei[0, :60] = 7                       # a hub above every fanout
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  return ei, jg, tg


@pytest.mark.parametrize('fanouts,num_nodes', [([2, 2], None),
                                               ([15, 10, 5], 300)])
def test_sample_prob_matches_jax(fanouts, num_nodes):
  """``sample_prob`` equals JAX's within rtol 1e-5 / atol 1e-6 (seeds at
  1, values in [0, 1]); test_neighbor_sampler.py:test_sample_prob's
  checks on the port's."""
  _, jg, tg = _graphs()
  seeds = np.array([0, 7, 42, 299])
  want = np.asarray(glt.sampler.NeighborSampler(jg, fanouts, seed=6)
                    .sample_prob(seeds, num_nodes))
  got = gtt.sampler.NeighborSampler(tg, fanouts, seed=6, device='cpu'
                                    ).sample_prob(seeds, num_nodes)
  assert got.dtype == torch.float32
  assert got.shape == want.shape == (num_nodes or 300,)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
  assert (got[seeds] == 1).all()
  assert ((got >= 0) & (got <= 1)).all()
  # test_neighbor_sampler.py's 8-node graph
  rows = [i for i in range(8) for _ in (0, 1)] + [0] * 7
  cols = [(i + d) % 8 for i in range(8) for d in (1, 2)] + list(range(1, 8))
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=8)
  small = gtt.sampler.NeighborSampler(
      gtt.data.Graph(topo, device='cpu'), [2, 2], seed=6,
      device='cpu').sample_prob(np.array([0]), 8)
  assert small[0] == 1.0 and small[1] > 0 and small[2] > 0


def test_frequency_partition_from_sample_prob_matches_jax(tmp_path):
  """The pre-sampling pipeline: per-partition ``sample_prob`` of two seed
  pools feeds ``FrequencyPartitioner`` (cache ratio 0.1) in each package;
  the probabilities agree within rtol 1e-5 and the partitions, fed each
  package's own probabilities, are equal."""
  ei, jg, tg = _graphs()
  n = 300
  feat = np.random.default_rng(1).standard_normal((n, 4)).astype(np.float32)
  pools = [np.arange(0, 150, 5), np.arange(150, 300, 5)]
  js = glt.sampler.NeighborSampler(jg, [5, 3], seed=0)
  ts = gtt.sampler.NeighborSampler(tg, [5, 3], seed=0, device='cpu')
  jprobs = [np.asarray(js.sample_prob(p)) for p in pools]
  tprobs = [ts.sample_prob(p).numpy() for p in pools]
  for a, b in zip(jprobs, tprobs):
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
  for pkg, d, probs in ((jpart, 'j', jprobs), (tpart, 't', tprobs)):
    pkg.FrequencyPartitioner(str(tmp_path / d), 2, n, ei, probs=probs,
                             node_feat=feat, chunk_size=25,
                             cache_ratio=0.1).partition()
  assert_parts_equal(str(tmp_path / 'j'), str(tmp_path / 't'), 2)
  _, _, nf0, _, node_pb, _ = tpart.load_partition(str(tmp_path / 't'), 0)
  assert nf0.cache_ids is not None and nf0.cache_ids.size == 15
  for p in range(2):
    _, g, nf, _, _, _ = tpart.load_partition(str(tmp_path / 't'), p)
    feats, ids, pb = tpart.cat_feature_cache(p, nf, node_pb)
    np.testing.assert_array_equal(feats, feat[ids])
    assert (pb[ids] == p).all()
