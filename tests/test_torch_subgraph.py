"""The port's induced-subgraph path against the JAX package, on the CPU.

- ``ops.node_subgraph`` and ``ops.node_subgraph_bucketed`` (a celebrity
  row, cap_large below and above the high-degree rows, an empty set).
- ``NeighborSampler.subgraph``, exact and bucketed, with ``with_edge``:
  nodes, relabeled edges, edge ids, mapping, dropped rows.
- ``SubGraphLoader`` batches with edge ids and edge features.
- ``sample_pyg_v1`` and ``sample_one_hop``.
Every array must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from test_torch_link import assert_outputs_equal

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _np(v):
  return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _celebrity_csr(n=50):
  """Node 0 -> 1..n-1 (degree n-1), a chain 1 -> 2 -> ... -> n-1."""
  rows = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n - 1)])
  cols = np.concatenate([np.arange(1, n), np.arange(2, n)])
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=n)
  return topo.indptr.astype(np.int32), topo.indices


def _dict_equal(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(_np(b[k]), _np(a[k]), err_msg=k)


@pytest.mark.parametrize('srcs', [np.arange(16), np.array([0, 3, 3, 9, 0]),
                                  np.array([5, 6])])
def test_node_subgraph_matches_jax(srcs):
  indptr, indices = _celebrity_csr()
  mask = np.ones(srcs.shape[0], bool)
  mask[-1] = srcs.shape[0] < 3       # a masked slot where there are many
  srcs = srcs.astype(np.int32)
  want = glt.ops.node_subgraph(jnp.asarray(indptr), jnp.asarray(indices),
                               jnp.asarray(srcs), jnp.asarray(mask),
                               max_degree=49)
  got = gtt.ops.node_subgraph(torch.as_tensor(indptr),
                              torch.as_tensor(indices),
                              torch.as_tensor(srcs), torch.as_tensor(mask),
                              max_degree=49)
  _dict_equal(want, got)


@pytest.mark.parametrize('cap_large', [1, 4, 32])
def test_node_subgraph_bucketed_celebrity_matches_jax(cap_large):
  indptr, indices = _celebrity_csr()
  # two high-degree rows: the celebrity and a second hub
  rows = np.concatenate([np.zeros(49, np.int64), np.arange(1, 49),
                         np.full(20, 7)])
  cols = np.concatenate([np.arange(1, 50), np.arange(2, 50),
                         np.arange(20) + 20])
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=50)
  indptr, indices = topo.indptr.astype(np.int32), topo.indices
  srcs = np.arange(16, dtype=np.int32)
  mask = np.ones(16, bool)
  want = glt.ops.node_subgraph_bucketed(
      jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(srcs),
      jnp.asarray(mask), deg_small=8, cap_large=cap_large, max_degree=49)
  got = gtt.ops.node_subgraph_bucketed(
      torch.as_tensor(indptr), torch.as_tensor(indices),
      torch.as_tensor(srcs), torch.as_tensor(mask), deg_small=8,
      cap_large=cap_large, max_degree=49)
  _dict_equal(want, got)
  assert int(got['num_dropped_rows']) == max(2 - cap_large, 0)


def _graphs(n=60, e=500, seed=2):
  rng = np.random.default_rng(seed)
  ei = rng.integers(0, n, (2, e))
  ei[0, :40] = 3                        # a high-degree row
  ei[:, 50:60] = ei[:, 60:70]           # repeated pairs
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  return ei, jg, tg


@pytest.mark.parametrize('dedup', ['auto', 'tree', 'map_table',
                                   'sort_legacy'])
@pytest.mark.parametrize('bucketed', [False, True])
def test_sampler_subgraph_with_edge_matches_jax(dedup, bucketed):
  ei, jg, tg = _graphs()
  js = glt.sampler.NeighborSampler(jg, [3, 2], seed=5, dedup=dedup,
                                   with_edge=True)
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=5, dedup=dedup,
                                   with_edge=True, device='cpu')
  for seeds in (np.array([0, 1]), np.array([3, 9, 9, 59]),
                np.array([59, 17, 4, 3, 2])):
    a = js.subgraph(glt.sampler.NodeSamplerInput(seeds), bucketed=bucketed,
                    cap_large=2 if bucketed else None)
    b = ts.subgraph(gtt.sampler.NodeSamplerInput(seeds), bucketed=bucketed,
                    cap_large=2 if bucketed else None)
    for f in ('node', 'num_nodes', 'row', 'col', 'edge', 'edge_mask',
              'batch'):
      np.testing.assert_array_equal(_np(getattr(b, f)),
                                    _np(getattr(a, f)), err_msg=f)
    _dict_equal(a.metadata, b.metadata)
    # every kept edge, mapped back through node, is an edge of the graph
    node, em = b.node.numpy(), b.edge_mask.numpy()
    got = set(zip(node[b.row.numpy()[em]].tolist(),
                  node[b.col.numpy()[em]].tolist()))
    assert got <= set(zip(ei[0].tolist(), ei[1].tolist()))
    for e, r, c in zip(b.edge.numpy()[em], b.row.numpy()[em],
                       b.col.numpy()[em]):
      assert (ei[0][e], ei[1][e]) == (node[r], node[c])
  assert ts._call_count == js._call_count == 3


def test_subgraph_loader_matches_jax():
  ei, _, _ = _graphs()
  n = 60
  rng = np.random.default_rng(0)
  feat = rng.standard_normal((n, 5)).astype(np.float32)
  efeat = rng.standard_normal((ei.shape[1], 3)).astype(np.float32)
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  jds.init_node_features(feat)
  jds.init_edge_features(efeat)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=n)
  tds.init_node_features(feat)
  tds.init_edge_features(efeat)
  for kw in (dict(), dict(bucketed=True, cap_large=2)):
    jl = glt.loader.SubGraphLoader(jds, [2, 2], np.arange(20),
                                   batch_size=8, with_edge=True, seed=1,
                                   **kw)
    tl = gtt.loader.SubGraphLoader(tds, [2, 2], np.arange(20),
                                   batch_size=8, with_edge=True, seed=1,
                                   device='cpu', **kw)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
      for f in ('node', 'num_nodes', 'node_mask', 'edge_index', 'edge_mask',
                'x', 'edge_ids', 'edge_attr', 'batch'):
        np.testing.assert_array_equal(_np(getattr(b, f)),
                                      _np(getattr(a, f)), err_msg=f)
      _dict_equal(a.metadata, b.metadata)
      mapping = b.metadata['mapping'].numpy()
      assert (mapping >= 0).all()
      np.testing.assert_array_equal(b.node.numpy()[mapping], b.batch.numpy())
      em = b.edge_mask.numpy()
      np.testing.assert_array_equal(b.edge_attr.numpy()[em],
                                    efeat[b.edge_ids.numpy()[em]])


@pytest.mark.parametrize('dedup', ['auto', 'tree'])
def test_sample_pyg_v1_matches_jax(dedup):
  _, jg, tg = _graphs()
  js = glt.sampler.NeighborSampler(jg, [4, 2], seed=8, dedup=dedup,
                                   with_edge=True)
  ts = gtt.sampler.NeighborSampler(tg, [4, 2], seed=8, dedup=dedup,
                                   with_edge=True, device='cpu')
  for cap in (None, 16):
    a = js.sample_pyg_v1(np.array([3, 4, 5]), batch_cap=cap)
    b = ts.sample_pyg_v1(np.array([3, 4, 5]), batch_cap=cap)
    assert a[0] == b[0] == 3
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    assert len(a[2]) == len(b[2]) == 2
    for ja, ta in zip(a[2], b[2]):
      for x, y in zip(ja[:3], ta[:3]):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
      assert ja[3] == ta[3]


@pytest.mark.parametrize('kw', [dict(), dict(strategy='block'),
                                dict(with_weight=True)])
def test_sample_one_hop_matches_jax(kw):
  rng = np.random.default_rng(4)
  ei = rng.integers(0, 40, (2, 400))
  w = (rng.integers(1, 9, 400) / 4).astype(np.float32)
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=40, edge_weights=w),
                      'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=40, edge_weights=w),
                      device='cpu')
  js = glt.sampler.NeighborSampler(jg, [5], seed=2, with_edge=True, **kw)
  ts = gtt.sampler.NeighborSampler(tg, [5], seed=2, with_edge=True,
                                   device='cpu', **kw)
  srcs = np.array([0, 39, 7, 7, 3], np.int32)
  mask = np.array([1, 1, 1, 0, 1], bool)
  for _ in range(2):
    a = js.sample_one_hop(jnp.asarray(srcs), jnp.asarray(mask), 5)
    b = ts.sample_one_hop(srcs, mask, 5)
    for f in ('nbrs', 'mask', 'edges'):
      np.testing.assert_array_equal(_np(getattr(b, f)),
                                    _np(getattr(a, f)), err_msg=f)
    np.testing.assert_array_equal(b.nbrs_num.numpy(), np.asarray(a.nbrs_num))


def test_with_edge_link_batch_edge_ids_decode():
  """A link batch with ``with_edge``: its edge ids decode to the sampled
  (neighbour, seed) pairs, as the JAX loader's do."""
  ei, jg, tg = _graphs()
  ts = gtt.sampler.NeighborSampler(tg, [3], seed=2, with_edge=True,
                                   device='cpu')
  js = glt.sampler.NeighborSampler(jg, [3], seed=2, with_edge=True)
  a = js.sample_from_edges(glt.sampler.EdgeSamplerInput(ei[0][:5],
                                                        ei[1][:5]))
  b = ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(ei[0][:5],
                                                        ei[1][:5]))
  assert_outputs_equal(a, b)
  node, em = b.node.numpy(), b.edge_mask.numpy()
  for e, r, c in zip(b.edge.numpy()[em], b.row.numpy()[em],
                     b.col.numpy()[em]):
    assert ei[0][e] == node[c] and ei[1][e] == node[r]
