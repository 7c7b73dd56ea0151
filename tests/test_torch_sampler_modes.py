"""The port's NeighborSampler against the JAX sampler in the products
example's other modes, on the CPU: block, padded window ('auto' and
explicit, before and after a reseed), weighted, and node_budget, each
under the tree and the merge engine; and ``with_edge`` on every backend
under the four engines (tree, merge, map_table, sort_legacy), with the
loaders' edge features.

Same graph, seed and call counter: every batch's node buffer, row, col,
edge mask, counts and overflow flag are equal, and so are the host call
counters. The weighted graphs carry dyadic weights, whose float32 row
CDF the JAX package computes exactly (see test_torch_neighbor_modes.py
for where it does not). Each validation error JAX raises is raised by
the port too.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _fields(out, torch_side):
  get = (lambda t: t.numpy()) if torch_side else np.asarray
  return {
      'node': get(out.node), 'row': get(out.row), 'col': get(out.col),
      'edge_mask': get(out.edge_mask), 'num_nodes': get(out.num_nodes),
      'overflow': get(out.metadata['overflow']),
      'num_sampled_nodes': np.asarray([int(c) for c in out.num_sampled_nodes]),
      'num_sampled_edges': np.asarray([int(c) for c in out.num_sampled_edges]),
  }


def _graphs(seed=6, n=160, e=2400):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, e)
  rows[:260] = 7            # a hub above every window
  rows[260:262] = n - 1
  cols = rng.integers(0, n, e)
  ei = np.stack([rows, cols])
  w = (rng.integers(1, 16, e) / 4).astype(np.float32)
  jg = glt.data.Graph(glt.data.Topology(ei, edge_weights=w, num_nodes=n),
                      'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n, edge_weights=w),
                      device='cpu')
  return jg, tg, rng, n


def _compare(js, ts, rng, n, steps=3, cap=16):
  for step in range(steps):
    seeds = np.concatenate([[7, n - 1, 0], rng.integers(0, n, 11)])
    a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap if step < 2 else None)
    b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap if step < 2 else None)
    fa, fb = _fields(a, False), _fields(b, True)
    for name in fa:
      np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
  assert ts._call_count == js._call_count


MODES = {
    'block': dict(strategy='block'),
    'padded_auto': dict(padded_window='auto'),
    'padded_32': dict(padded_window=32),
    'weighted': dict(with_weight=True),
    'budget': dict(node_budget=40),
    'block_budget': dict(strategy='block', node_budget=40),
    'padded_budget': dict(padded_window=16, node_budget=40),
    'weighted_budget': dict(with_weight=True, node_budget=40),
}


@pytest.mark.parametrize('dedup', ['tree', 'merge'])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_sampler_mode_stream_matches_jax(mode, dedup):
  jg, tg, rng, n = _graphs()
  kw = MODES[mode]
  js = glt.sampler.NeighborSampler(jg, [5, 3], seed=3, dedup=dedup, **kw)
  ts = gtt.sampler.NeighborSampler(tg, [5, 3], seed=3, dedup=dedup,
                                   device='cpu', **kw)
  assert ts.padded_window == js.padded_window
  assert ts.hop_caps(16) == js.hop_caps(16)
  _compare(js, ts, rng, n)
  if ts.padded_window is not None:
    js.refresh_padded_table()
    ts.refresh_padded_table()
    _compare(js, ts, rng, n, steps=2)
    js.refresh_padded_table(seed=41)
    ts.refresh_padded_table(seed=41)
    _compare(js, ts, rng, n, steps=1)


def test_padded_table_reseed_is_in_place_and_differs():
  jg, tg, rng, n = _graphs()
  ts = gtt.sampler.NeighborSampler(tg, [5, 3], seed=3, dedup='tree',
                                   padded_window=16, device='cpu')
  js = glt.sampler.NeighborSampler(jg, [5, 3], seed=3, dedup='tree',
                                   padded_window=16)
  tab = ts._padded_arrays()['tab']
  first = tab.clone()
  np.testing.assert_array_equal(first.numpy(),
                                np.asarray(js._padded_arrays()['tab']))
  ts.refresh_padded_table()
  js.refresh_padded_table()
  assert ts._padded_arrays()['tab'] is tab     # the same storage
  assert not bool((tab == first).all())
  np.testing.assert_array_equal(tab.numpy(),
                                np.asarray(js._padded_arrays()['tab']))


def test_node_budget_overflow_flag_and_no_raise():
  # a budget below the merge frontier: the flag is set (as in JAX) but
  # the loader's 'raise' guard watches frontier_caps only
  jg, tg, rng, n = _graphs()
  js = glt.sampler.NeighborSampler(jg, [5, 3], seed=3, dedup='merge',
                                   node_budget=12)
  ts = gtt.sampler.NeighborSampler(tg, [5, 3], seed=3, dedup='merge',
                                   node_budget=12, device='cpu')
  assert not ts.clamped_exact and not js.clamped_exact
  seeds = np.arange(16)
  a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds), batch_cap=16)
  b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds), batch_cap=16)
  assert bool(np.asarray(a.metadata['overflow']))
  assert bool(b.metadata['overflow'])
  ds = gtt.data.Dataset(device='cpu')
  ds.graph = tg
  ds.init_node_features(np.ones((n, 3), np.float32))
  ds.init_node_labels(np.zeros(n, np.int64))
  loader = gtt.loader.NeighborLoader(ds, [5, 3], np.arange(48),
                                     batch_size=16, dedup='merge',
                                     node_budget=12, device='cpu',
                                     overflow_policy='raise')
  assert not loader._overflow_guarded()
  assert len(list(loader)) == 3


def test_loader_reseeds_the_padded_table_each_later_epoch():
  jg, tg, rng, n = _graphs()
  ds = gtt.data.Dataset(device='cpu')
  ds.graph = tg
  ds.init_node_features(np.ones((n, 3), np.float32))
  ds.init_node_labels(np.zeros(n, np.int64))
  loader = gtt.loader.NeighborLoader(ds, [5, 3], np.arange(32),
                                     batch_size=16, dedup='tree', seed=2,
                                     padded_window=16, device='cpu')
  seeds_seen = []
  for _ in range(3):
    list(loader)
    seeds_seen.append(loader.sampler._padded_seed)
  assert seeds_seen == [2, 3, 4] and loader._epochs_started == 3


_ERRORS = [
    dict(strategy='block', with_weight=True),
    dict(strategy='block', padded_window=16),
    dict(strategy='block', fanouts=[17, 2]),
    dict(padded_window=16, with_weight=True),
    dict(padded_window=4),
    dict(padded_window='auto', fanouts=None),
    dict(frontier_caps=[8, 8], dedup='tree'),
    dict(frontier_caps={'a': [1]}),
]


@pytest.mark.parametrize('case', range(len(_ERRORS)))
def test_sampler_validation_errors_match_jax(case):
  jg, tg, _, _ = _graphs()
  kw = dict(_ERRORS[case])
  fanouts = kw.pop('fanouts', [5, 3])
  with pytest.raises(ValueError) as jerr:
    glt.sampler.NeighborSampler(jg, fanouts, **kw)
  with pytest.raises(ValueError) as terr:
    gtt.sampler.NeighborSampler(tg, fanouts, device='cpu', **kw)
  assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------- with_edge, engines

BACKENDS = {'fused': {}, 'block': dict(strategy='block'),
            'padded': dict(padded_window=16), 'weighted': dict(with_weight=True)}


@pytest.mark.parametrize('dedup', ['tree', 'merge', 'map_table',
                                   'sort_legacy'])
@pytest.mark.parametrize('backend', sorted(BACKENDS))
def test_with_edge_on_every_backend_matches_jax(backend, dedup):
  """``with_edge`` batches of every hop backend under every engine: the
  JAX sampler's fields and edge ids (the fused backend is the hop kernel's
  and the level kernel's plain paths here), and the ids decode to the
  sampled (seed, neighbour) pairs of the input COO."""
  jg, tg, rng, n = _graphs(e=900)
  kw = BACKENDS[backend]
  js = glt.sampler.NeighborSampler(jg, [5, 3], seed=3, dedup=dedup,
                                   with_edge=True, **kw)
  ts = gtt.sampler.NeighborSampler(tg, [5, 3], seed=3, dedup=dedup,
                                   with_edge=True, device='cpu', **kw)
  rows, cols = jg.topo.to_coo()
  coo_rows = np.empty_like(rows)
  coo_cols = np.empty_like(cols)
  coo_rows[jg.topo.edge_ids], coo_cols[jg.topo.edge_ids] = rows, cols
  for step in range(2):
    seeds = np.concatenate([[7, n - 1, 0], rng.integers(0, n, 11)])
    a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds))
    b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds))
    fa, fb = _fields(a, False), _fields(b, True)
    for name in fa:
      np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
    np.testing.assert_array_equal(b.edge.numpy(), np.asarray(a.edge))
    em = b.edge_mask.numpy()
    assert (b.edge.numpy()[~em] == -1).all()
    node = b.node.numpy()
    e = b.edge.numpy()[em]
    np.testing.assert_array_equal(coo_rows[e], node[b.col.numpy()[em]])
    np.testing.assert_array_equal(coo_cols[e], node[b.row.numpy()[em]])


@pytest.mark.parametrize('dedup', ['tree', 'merge', 'map_table',
                                   'sort_legacy'])
def test_loader_edge_attr_matches_jax(dedup):
  """A ``with_edge`` loader over a dataset with edge features and given
  edge ids: ``edge_ids`` and ``edge_attr`` as the JAX loader's, on a CSC
  graph with repeated (row, col) pairs."""
  rng = np.random.default_rng(9)
  n, e = 50, 500
  ei = rng.integers(0, n, (2, e))
  ei[:, 100:150] = ei[:, :50]
  eids = rng.permutation(e)
  efeat = rng.standard_normal((e, 3)).astype(np.float32)
  jds = glt.data.Dataset(edge_dir='in')
  jds.init_graph(ei, edge_ids=eids, num_nodes=n, graph_mode='CPU')
  jds.init_edge_features(efeat)
  tds = gtt.data.Dataset(edge_dir='in', device='cpu')
  tds.init_graph(ei, edge_ids=eids, num_nodes=n)
  tds.init_edge_features(efeat)
  np.testing.assert_array_equal(tds.graph.edge_ids.numpy(),
                                jds.graph.topo.edge_ids)
  jl = glt.loader.NeighborLoader(jds, [4, 2], np.arange(30), batch_size=8,
                                 with_edge=True, dedup=dedup, seed=2)
  tl = gtt.loader.NeighborLoader(tds, [4, 2], np.arange(30), batch_size=8,
                                 with_edge=True, dedup=dedup, seed=2,
                                 device='cpu')
  for a, b in zip(jl, tl):
    for f in ('node', 'edge_index', 'edge_mask', 'edge_ids', 'edge_attr'):
      np.testing.assert_array_equal(getattr(b, f).numpy(),
                                    np.asarray(getattr(a, f)), err_msg=f)
