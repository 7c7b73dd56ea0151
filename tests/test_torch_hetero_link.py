"""The port's typed link sampling and typed link loaders against the JAX
package's, on the CPU.

Same typed graph, same seed, same seed edges: every node buffer, row,
col, edge mask and count of every typed link batch is equal, and so are
its link metadata (``edge_label_index`` / ``edge_label``, or
``src_index`` / ``dst_pos_index`` / ``dst_neg_index``), its input type,
its batch size and the sampler's call counter (one key for the
negatives, then one per (hop, edge type) item). Covers binary, triplet
and no negatives, both edge directions, the tree and the calibrated
merge engines, an edge type within one node type and a bipartite one;
the refusals (an explicit key, ``overflow_policy='recompute'``); and
tests/test_loader.py's typed link loader cases, batch for batch.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from test_torch_hetero_sampler import (CITES, REV, TAG, WRITES, both_graphs,
                                       fields, typed_edges)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

FAN = {CITES: [3, 2], WRITES: [2, 2], REV: [2, 1], TAG: [1, 0]}
LINK_KEYS = ('edge_label_index', 'edge_label', 'src_index',
             'dst_pos_index', 'dst_neg_index')


def _host(v):
  return v.numpy() if hasattr(v, 'numpy') and not isinstance(
      v, np.ndarray) and type(v).__module__.startswith('torch') \
      else np.asarray(v)


def assert_link_batches_equal(a, b):
  """Two typed link batches (sampler outputs or ``HeteroData``) equal in
  every field, their link metadata, input type and batch size."""
  if hasattr(a, 'row'):
    fa, fb = fields(a), fields(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
      np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
    assert a.input_type == b.input_type
  else:
    for name in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x',
                 'batch'):
      da, db = getattr(a, name), getattr(b, name)
      if da is None:
        assert db is None, name
        continue
      assert list(da) == list(db), name
      for k in da:
        np.testing.assert_array_equal(_host(da[k]), _host(db[k]),
                                      err_msg=f'{name}/{k}')
  assert a.batch_size == b.batch_size
  keys = [k for k in LINK_KEYS if k in a.metadata]
  assert keys == [k for k in LINK_KEYS if k in b.metadata]
  for k in keys:
    ja, tb = _host(a.metadata[k]), _host(b.metadata[k])
    assert ja.dtype == tb.dtype, (k, ja.dtype, tb.dtype)
    np.testing.assert_array_equal(ja, tb, err_msg=k)


def _negs(mode, amount):
  if mode is None:
    return None, None
  return (glt.sampler.NegativeSampling(mode, amount),
          gtt.sampler.NegativeSampling(mode, amount))


def _samplers(jg, tg, engine, edge_dir, seed=3):
  kw = dict(dedup='tree')
  if engine == 'merge':
    caps = glt.sampler.estimate_hetero_frontier_caps(
        jg, FAN, {'paper': 16, 'author': 16}, edge_dir=edge_dir,
        num_probes=4, slack=1.2, seed=1, multiple=4)
    assert gtt.sampler.estimate_hetero_frontier_caps(
        tg, FAN, {'paper': 16, 'author': 16}, edge_dir=edge_dir,
        num_probes=4, slack=1.2, seed=1, multiple=4) == caps
    kw = dict(dedup='merge', frontier_caps=caps)
  return (glt.sampler.NeighborSampler(jg, FAN, seed=seed, edge_dir=edge_dir,
                                      **kw),
          gtt.sampler.NeighborSampler(tg, FAN, seed=seed, edge_dir=edge_dir,
                                      device='cpu', **kw))


# every pair of (edge direction, engine, seed edge type, negatives) in
# eight cases: an edge type within one node type (cites) and a bipartite
# one (writes); binary negatives 2 a positive, triplet 2, none
CASES = [
    ('out', 'tree', CITES, None),
    ('out', 'merge', WRITES, None),
    ('in', 'tree', WRITES, ('binary', 2)),
    ('in', 'merge', CITES, ('binary', 2)),
    ('out', 'tree', WRITES, ('triplet', 2)),
    ('in', 'merge', CITES, ('triplet', 2)),
    ('in', 'tree', CITES, None),
    ('out', 'merge', CITES, ('binary', 2))]


@pytest.mark.parametrize('edge_dir,engine,etype,neg', CASES)
def test_typed_link_batches_match_jax(edge_dir, engine, etype, neg):
  """``sample_from_edges`` on typed seed edges: two batches (the second
  with labels) equal JAX's field for field, metadata and call counter
  included."""
  edges, num_nodes, _ = typed_edges(edge_dir=edge_dir)
  jg, tg = both_graphs(edges, num_nodes, edge_dir=edge_dir)
  js, ts = _samplers(jg, tg, engine, edge_dir)
  jn, tn = _negs(*(neg or (None, None)))
  ei = edges[etype]
  for i, sl in enumerate((slice(0, 12), slice(40, 52))):
    label = (np.arange(sl.stop - sl.start) % 2).astype(np.int64) if i \
        else None
    a = js.sample_from_edges(glt.sampler.EdgeSamplerInput(
        ei[0, sl], ei[1, sl], label, etype, jn))
    b = ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
        ei[0, sl], ei[1, sl], label, etype, tn))
    assert b.input_type == etype
    assert_link_batches_equal(a, b)
    assert ts._call_count == js._call_count
  src_t, _, dst_t = etype
  # the metadata decodes to the seed edges through each type's buffer
  eli = _host(b.metadata['edge_label_index'] if neg is None or
              neg[0] == 'binary' else
              np.stack([_host(b.metadata['src_index']),
                        _host(b.metadata['dst_pos_index'])]))
  np.testing.assert_array_equal(_host(b.node[src_t])[eli[0, :12]],
                                ei[0, sl])
  np.testing.assert_array_equal(_host(b.node[dst_t])[eli[1, :12]],
                                ei[1, sl])


def test_typed_link_negative_range_is_jax_s():
  """The negatives' id ranges are JAX's: the CSR's row count and the
  largest neighbour id plus one (here below the other type's node
  count), read once per edge type; ``num_dst_nodes`` overrides the
  second."""
  edges, num_nodes, _ = typed_edges()
  # no writes edge reaches the last 20 papers
  edges[WRITES] = edges[WRITES][:, edges[WRITES][1] < 100]
  jg, tg = both_graphs(edges, num_nodes)
  js, ts = _samplers(jg, tg, 'tree', 'out')
  assert ts._neg_range(WRITES) == (70, int(edges[WRITES][1].max()) + 1)
  jn, tn = _negs('binary', 3)
  ei = edges[WRITES]
  for kw in ({}, {'num_dst_nodes': 120}):
    a = js.sample_from_edges(glt.sampler.EdgeSamplerInput(
        ei[0, :9], ei[1, :9], None, WRITES, jn), **kw)
    b = ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
        ei[0, :9], ei[1, :9], None, WRITES, tn), **kw)
    assert_link_batches_equal(a, b)
  assert list(ts._neg_ranges) == [WRITES]
  assert list(ts._neg_indices) == [WRITES]


def test_typed_link_refusals_in_jax_words():
  """An explicit key is refused on a typed graph, and so is
  ``overflow_policy='recompute'`` in the typed link loader, as in JAX."""
  edges, num_nodes, _ = typed_edges()
  jg, tg = both_graphs(edges, num_nodes)
  _, ts = _samplers(jg, tg, 'tree', 'out')
  inp = gtt.sampler.EdgeSamplerInput(np.arange(3), np.arange(3),
                                     input_type=CITES)
  with pytest.raises(NotImplementedError, match='homogeneous-only'):
    ts.sample_from_edges(inp, key=gtt.random.PRNGKey(0))
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph(edges, num_nodes=num_nodes)
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU', num_nodes=num_nodes)
  for pkg, dset, kw in ((glt, jds, {}), (gtt, ds, dict(device='cpu'))):
    with pytest.raises(ValueError, match='homogeneous-only'):
      pkg.loader.LinkNeighborLoader(
          dset, FAN, (CITES, edges[CITES][:, :8]), batch_size=4,
          overflow_policy='recompute', dedup='merge', **kw)


def make_hetero_datasets():
  """tests/test_loader.py's typed dataset in both packages."""
  ub = np.array([[0, 0, 1, 2, 2, 3], [0, 1, 2, 3, 0, 1]])
  bu = ub[::-1].copy()
  edges = {('user', 'buys', 'item'): ub, ('item', 'rev_buys', 'user'): bu}
  nodes = {('user', 'buys', 'item'): 4, ('item', 'rev_buys', 'user'): 4}
  feats = {'user': np.eye(4, dtype=np.float32),
           'item': np.eye(4, dtype=np.float32) * 2}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU', num_nodes=nodes)
  jds.init_node_features(feats)
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph(edges, num_nodes=nodes)
  ds.init_node_features(feats)
  return jds, ds, ub


@pytest.mark.parametrize('mode,fanouts,amount,seed', [
    ('binary', [2, 2], 1, 0), ('triplet', [2], 2, 1)])
def test_typed_link_loader_matches_jax_batch_for_batch(mode, fanouts,
                                                      amount, seed):
  """tests/test_loader.py:106-141 on both packages: the typed
  ``LinkNeighborLoader``'s batches equal JAX's (nodes, edges, per-type
  features, metadata), and the JAX test's own checks hold on the
  port's."""
  jds, ds, ub = make_hetero_datasets()
  et = ('user', 'buys', 'item')
  jn, tn = _negs(mode, amount)
  jl = glt.loader.LinkNeighborLoader(jds, fanouts, (et, ub),
                                     neg_sampling=jn, batch_size=3,
                                     seed=seed)
  tl = gtt.loader.LinkNeighborLoader(ds, fanouts, (et, ub),
                                     neg_sampling=tn, batch_size=3,
                                     seed=seed, device='cpu')
  jb, tb = list(jl), list(tl)
  assert len(jb) == len(tb) == 2
  for a, b in zip(jb, tb):
    assert isinstance(b, gtt.loader.HeteroData)
    assert_link_batches_equal(a, b)
  assert tl.sampler._call_count == jl.sampler._call_count
  b = tb[0]
  user_nodes, item_nodes = b.node['user'].numpy(), b.node['item'].numpy()
  if mode == 'binary':
    eli = b.metadata['edge_label_index'].numpy()
    label = b.metadata['edge_label'].numpy()
    assert eli.shape == (2, 6) and label.shape == (6,)
    assert label[:3].sum() == 3 and label[3:].sum() == 0
    pos = {(int(r), int(c)) for r, c in zip(ub[0], ub[1])}
    for j in range(3):
      assert (int(user_nodes[eli[0, j]]), int(item_nodes[eli[1, j]])) in pos
    assert b.x['user'].shape[1] == 4
  else:
    assert b.metadata['src_index'].shape == (3,)
    assert b.metadata['dst_pos_index'].shape == (3,)
    assert b.metadata['dst_neg_index'].shape == (6,)
    np.testing.assert_array_equal(
        user_nodes[b.metadata['src_index'].numpy()], ub[0][:3])


@pytest.mark.parametrize('dedup', ['tree', 'merge'])
def test_typed_link_loader_with_typed_fanouts_matches_jax(dedup):
  """The typed link loader with per-edge-type fanouts, shuffled, over the
  paper/author graph with per-type features: an epoch of batches equal
  to JAX's, features gathered per featured type."""
  edges, num_nodes, _ = typed_edges()
  rng = np.random.default_rng(5)
  feats = {'paper': rng.standard_normal((120, 6)).astype(np.float32),
           'author': rng.standard_normal((70, 6)).astype(np.float32)}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU', num_nodes=num_nodes)
  jds.init_node_features(feats)
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph(edges, num_nodes=num_nodes)
  ds.init_node_features(feats)
  jn, tn = _negs('binary', 1)
  kw = dict(batch_size=16, shuffle=True, drop_last=True, seed=2,
            dedup=dedup)
  seeds = (WRITES, edges[WRITES][:, :64])
  jl = glt.loader.LinkNeighborLoader(jds, FAN, seeds, neg_sampling=jn, **kw)
  tl = gtt.loader.LinkNeighborLoader(ds, FAN, seeds, neg_sampling=tn,
                                     device='cpu', **kw)
  n = 0
  for a, b in zip(jl, tl):
    assert_link_batches_equal(a, b)
    assert set(b.x) == {'paper', 'author'}
    n += 1
  assert n == 4 and tl.sampler._call_count == jl.sampler._call_count
