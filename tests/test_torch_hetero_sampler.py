"""The port's typed sampler against the JAX package's: the typed plans,
the calibration, and the typed engine batch for batch.

Same typed graph, same seed, same seed batches: every node buffer, row,
col, edge mask, edge id and count of every batch is equal, and so is the
sampler's call counter (one key per (hop, edge type) item). Mirrors the
typed cases of tests/test_neighbor_sampler.py.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV = ('paper', 'rev_writes', 'author')
TAG = ('paper', 'tags', 'topic')
SIZES = {'paper': 120, 'author': 70, 'topic': 20}


def typed_edges(seed=4, with_tags=True, edge_dir='out'):
  """A paper/author(/topic) graph in both packages' input form:
  ``(edges, num_nodes, weights)``; ``num_nodes`` keys each edge type by
  its stored key type (src under 'out', dst under 'in')."""
  rng = np.random.default_rng(seed)
  n = SIZES
  edges = {
      CITES: np.stack([rng.integers(0, n['paper'], 700),
                       rng.integers(0, n['paper'], 700)]),
      WRITES: np.stack([rng.integers(0, n['author'], 350),
                        rng.integers(0, n['paper'], 350)]),
      REV: np.stack([rng.integers(0, n['paper'], 350),
                     rng.integers(0, n['author'], 350)]),
  }
  # a hub paper above every fanout
  edges[CITES][0, :40] = 3
  if with_tags:
    edges[TAG] = np.stack([rng.integers(0, n['paper'], 240),
                           rng.integers(0, n['topic'], 240)])
  key = 0 if edge_dir == 'out' else 2
  num_nodes = {et: n[et[key]] for et in edges}
  # dyadic weights with small totals: the float32 row CDFs agree exactly
  weights = {et: rng.integers(1, 5, ei.shape[1]).astype(np.float32) / 4
             for et, ei in edges.items()}
  return edges, num_nodes, weights


def both_graphs(edges, num_nodes, weights=None, edge_dir='out'):
  layout = 'CSR' if edge_dir == 'out' else 'CSC'
  jg, tg = {}, {}
  for et, ei in edges.items():
    w = None if weights is None else weights[et]
    jg[et] = glt.data.Graph(glt.data.Topology(
        ei, edge_weights=w, layout=layout, num_nodes=num_nodes[et]), 'CPU')
    tg[et] = gtt.data.Graph(gtt.data.Topology(
        ei, edge_weights=w, layout=layout, num_nodes=num_nodes[et]),
        device='cpu')
  return jg, tg


def fields(out):
  """Every comparable field of a typed batch, as numpy."""
  def host(v):
    return v.numpy() if hasattr(v, 'numpy') and not isinstance(
        v, np.ndarray) and type(v).__module__.startswith('torch') \
        else np.asarray(v)

  f = {}
  for t in out.node:
    f[f'node/{t}'] = host(out.node[t])
    f[f'num_nodes/{t}'] = host(out.num_nodes[t])
    f[f'nsn/{t}'] = np.asarray([int(c) for c in out.num_sampled_nodes[t]])
  for et in out.row:
    f[f'row/{et}'] = host(out.row[et])
    f[f'col/{et}'] = host(out.col[et])
    f[f'edge_mask/{et}'] = host(out.edge_mask[et])
    f[f'nse/{et}'] = np.asarray([int(c) for c in out.num_sampled_edges[et]])
    if out.edge is not None:
      f[f'edge/{et}'] = host(out.edge[et])
  for t in out.batch:
    f[f'batch/{t}'] = host(out.batch[t])
  f['overflow'] = np.asarray(bool(host(out.metadata['overflow'])))
  f['seed_inverse'] = host(out.metadata['seed_inverse'])
  return f


def assert_batches_equal(a, b):
  fa, fb = fields(a), fields(b)
  assert sorted(fa) == sorted(fb), (sorted(fa), sorted(fb))
  for name in fa:
    np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
  assert list(a.node) == list(b.node) and list(a.row) == list(b.row)
  assert a.input_type == b.input_type and a.batch_size == b.batch_size


FAN = {CITES: [3, 2], WRITES: [2, 2], REV: [2, 1], TAG: [1, 0]}


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
@pytest.mark.parametrize('calibrated', [False, True])
def test_hetero_plans_match_jax(edge_dir, calibrated):
  """hetero_capacity_plan, hetero_tree_layout and hetero_tree_blocks,
  with and without calibrated per-(hop, edge type) caps, and the
  calibration itself, equal JAX's."""
  edges, num_nodes, _ = typed_edges(edge_dir=edge_dir)
  jg, tg = both_graphs(edges, num_nodes, edge_dir=edge_dir)
  seed_t = 'paper'
  caps_j = caps_t = None
  if calibrated:
    kw = dict(edge_dir=edge_dir, num_probes=5, slack=1.5, seed=2,
              multiple=4)
    caps_j = glt.sampler.estimate_hetero_frontier_caps(
        jg, FAN, {seed_t: 8}, **kw)
    caps_t = gtt.sampler.estimate_hetero_frontier_caps(
        tg, FAN, {seed_t: 8}, **kw)
    assert caps_t == caps_j
    pool = {seed_t: np.arange(0, 120, 3)}
    assert gtt.sampler.estimate_hetero_frontier_caps(
        tg, [2, 2], {seed_t: 16}, input_nodes=pool, **kw) == \
        glt.sampler.estimate_hetero_frontier_caps(
            jg, [2, 2], {seed_t: 16}, input_nodes=pool, **kw)
  from graphlearn_tpu.sampler import neighbor_sampler as jns
  from graphlearn_tpu_torch.sampler import neighbor_sampler as tns
  fo = lambda et: FAN[et]   # noqa: E731
  for etypes in (list(FAN), list(reversed(list(FAN)))):
    assert tns.hetero_capacity_plan(etypes, fo, {seed_t: 8}, edge_dir,
                                    etype_caps=caps_t) == \
        jns.hetero_capacity_plan(etypes, fo, {seed_t: 8}, edge_dir,
                                 etype_caps=caps_j)
    assert gtt.sampler.hetero_tree_layout(
        {seed_t: 8}, etypes, FAN, edge_dir, etype_caps=caps_t) == \
        glt.sampler.hetero_tree_layout({seed_t: 8}, etypes, FAN, edge_dir,
                                       etype_caps=caps_j)
    assert gtt.sampler.hetero_tree_blocks(
        {seed_t: 8}, etypes, FAN, edge_dir, etype_caps=caps_t) == \
        glt.sampler.hetero_tree_blocks({seed_t: 8}, etypes, FAN, edge_dir,
                                       etype_caps=caps_j)
  items = list(tns.hetero_capacity_plan(list(FAN), fo, {seed_t: 8},
                                        edge_dir)[1][-1].items())
  assert tns._final_touch_map(items, edge_dir) == \
      jns._final_touch_map(items, edge_dir)


CASES = {
    'tree': dict(dedup='tree'),
    'merge': dict(dedup='merge'),
    'merge_calibrated': dict(dedup='merge', calibrate=True),
    'sort_legacy': dict(dedup='sort_legacy'),
    'block_tree': dict(dedup='tree', strategy='block'),
    'block_merge': dict(dedup='merge', strategy='block'),
    'weighted_tree': dict(dedup='tree', with_weight=True),
    'weighted_merge': dict(dedup='merge', with_weight=True,
                           calibrate=True),
    'with_edge_merge': dict(dedup='merge', with_edge=True),
    'with_edge_tree': dict(dedup='tree', with_edge=True),
}


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
@pytest.mark.parametrize('case', list(CASES))
def test_hetero_stream_matches_jax(case, edge_dir):
  """The typed engine, batch for batch over one sampler's stream, in
  tree, merge (with and without calibrated caps), block, weighted and
  with_edge modes: ids, masks, counts and the call counter equal JAX's."""
  kw = dict(CASES[case])
  calibrate = kw.pop('calibrate', False)
  edges, num_nodes, weights = typed_edges(edge_dir=edge_dir)
  with_w = kw.get('with_weight', False)
  jg, tg = both_graphs(edges, num_nodes, weights if with_w else None,
                       edge_dir)
  fan = {et: [min(k, 2) for k in v] for et, v in FAN.items()} \
      if kw.get('strategy') == 'block' else FAN
  if calibrate:
    kw['frontier_caps'] = glt.sampler.estimate_hetero_frontier_caps(
        jg, fan, {'paper': 16}, edge_dir=edge_dir, num_probes=4,
        slack=2.0, multiple=8)
  js = glt.sampler.NeighborSampler(jg, fan, seed=5, edge_dir=edge_dir,
                                   **kw)
  ts = gtt.sampler.NeighborSampler(tg, fan, seed=5, edge_dir=edge_dir,
                                   device='cpu', **kw)
  rng = np.random.default_rng(1)
  for step in range(3):
    seeds = np.concatenate([[3, 119], rng.integers(0, 120, 10)])
    cap = 16 if step < 2 else None     # a padded and a rounded-up batch
    a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds, 'paper'),
                             batch_cap=cap)
    b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds, 'paper'),
                             batch_cap=cap)
    assert_batches_equal(a, b)
  assert ts._call_count == js._call_count > 3
  assert ts.state_dict()['base_key'] == np.asarray(js._key).tolist()


def test_hetero_multi_type_seeds_match_jax():
  """Seeds of several types at once (``{ntype: ids}``): each type padded
  to a multiple of 8, one state each."""
  edges, num_nodes, _ = typed_edges(with_tags=False)
  jg, tg = both_graphs(edges, num_nodes)
  js = glt.sampler.NeighborSampler(jg, [2, 2], seed=2, dedup='merge')
  ts = gtt.sampler.NeighborSampler(tg, [2, 2], seed=2, dedup='merge',
                                   device='cpu')
  inp = {'paper': np.array([1, 2, 5]), 'author': np.array([0, 9, 9, 4])}
  a = js._hetero_sample_from_nodes(inp)
  b = ts._hetero_sample_from_nodes(inp)
  assert_batches_equal(a, b)
  for t in inp:
    np.testing.assert_array_equal(
        np.asarray(a.metadata['seed_inverse_dict'][t]),
        b.metadata['seed_inverse_dict'][t].numpy())


def test_hetero_overflow_flag_matches_jax():
  """Tiny calibrated caps truncate: both engines raise the on-device
  flag and keep the same truncated batch; caps at the worst case leave
  the uncapped batch byte for byte."""
  edges, num_nodes, _ = typed_edges()
  jg, tg = both_graphs(edges, num_nodes)
  fan = [3, 2]
  tiny = {et: [1, 1] for et in edges}
  js = glt.sampler.NeighborSampler(jg, fan, seed=5, dedup='merge',
                                   frontier_caps=tiny)
  ts = gtt.sampler.NeighborSampler(tg, fan, seed=5, dedup='merge',
                                   frontier_caps=tiny, device='cpu')
  inp = (np.arange(32), 'paper')
  a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(*inp))
  b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(*inp))
  assert bool(b.metadata['overflow'])
  assert_batches_equal(a, b)
  _, hop_caps, _ = gtt.sampler.hetero_capacity_plan(
      list(tg), lambda et: fan, {'paper': 32}, 'out')
  worst = {}
  for h, per_et in enumerate(hop_caps):
    for et, (fcap, k, cap) in per_et.items():
      worst.setdefault(et, [0] * len(hop_caps))[h] = cap
  base = gtt.sampler.NeighborSampler(tg, fan, seed=3, dedup='merge',
                                     device='cpu')
  capped = gtt.sampler.NeighborSampler(tg, fan, seed=3, dedup='merge',
                                       frontier_caps=worst, device='cpu')
  o1 = base.sample_from_nodes(gtt.sampler.NodeSamplerInput(*inp))
  o2 = capped.sample_from_nodes(gtt.sampler.NodeSamplerInput(*inp))
  assert not bool(o2.metadata['overflow'])
  f1, f2 = fields(o1), fields(o2)
  for name in f1:
    np.testing.assert_array_equal(f1[name], f2[name], err_msg=name)


def _adj(edges):
  return {et: {(int(a), int(b)) for a, b in zip(ei[0], ei[1])}
          for et, ei in edges.items()}


def test_hetero_tree_and_block_structure():
  """Typed tree mode and typed block sampling (tests/
  test_neighbor_sampler.py's test_hetero_tree_mode and
  test_hetero_block_sampling): per-type positional slots, seeds lead
  the input type's buffer, every valid edge decodes to a real typed
  edge under the reversed type."""
  et = ('u', 'to', 'v')
  rev = gtt.typing.reverse_edge_type(et)
  for n, strategy in ((8, 'random'), (40, 'block')):
    ei = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    graphs = {et: gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n),
                                 device='cpu')}
    s = gtt.sampler.NeighborSampler(graphs, {et: [2]}, seed=0,
                                    dedup='tree', strategy=strategy,
                                    device='cpu')
    out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(
        np.array([0, 3]), 'u'))
    nu, nv = out.node['u'].numpy(), out.node['v'].numpy()
    np.testing.assert_array_equal(nu[:2], [0, 3])
    m = out.edge_mask[rev].numpy()
    assert m.sum() > 0
    for ri, ci in zip(out.row[rev].numpy()[m], out.col[rev].numpy()[m]):
      assert int(nv[ri]) == (int(nu[ci]) + 1) % n


def test_hetero_sample_from_nodes_trim():
  """Typed merge batches trim to exact-size typed arrays (tests/
  test_neighbor_sampler.py's test_hetero_sample_from_nodes)."""
  ub = np.array([[0, 0, 1, 2], [0, 1, 2, 0]])
  graphs = {('user', 'buys', 'item'): gtt.data.Graph(
                gtt.data.Topology(ub, num_nodes=3), device='cpu'),
            ('item', 'rev_buys', 'user'): gtt.data.Graph(
                gtt.data.Topology(ub[::-1].copy(), num_nodes=4),
                device='cpu')}
  adj = {(int(r), int(c)) for r, c in zip(ub[0], ub[1])}
  s = gtt.sampler.NeighborSampler(graphs, [2, 2], seed=7, device='cpu')
  out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(
      np.array([0, 1]), input_type='user')).trim()
  assert set(out.node['user'][:2].tolist()) == {0, 1}
  rev = ('item', 'rev_buys', 'user')
  assert rev in out.row and out.edge_mask is None
  for r, c in zip(out.row[rev], out.col[rev]):
    assert (int(out.node['user'][c]), int(out.node['item'][r])) in adj
  for t, buf in out.node.items():
    assert buf.shape[0] == out.num_nodes[t]
    assert len(set(buf.tolist())) == buf.shape[0]      # exact dedup


def test_hetero_calibrated_structure_and_shrink():
  """Calibrated caps shrink the typed plan well below the compounding
  worst case; calibrated batches do not overflow at the calibrated width,
  keep per-type buffers duplicate-free, and every valid edge is a real
  typed edge (tests/test_neighbor_sampler.py:512-632)."""
  edges, num_nodes, _ = typed_edges()
  _, tg = both_graphs(edges, num_nodes)
  adj = _adj(edges)
  fan, b = [3, 2], 32
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      tg, fan, {'paper': b}, num_probes=6, slack=1.5, multiple=8)
  assert set(caps) == set(tg) and all(len(v) == 2 for v in caps.values())
  ets = list(tg)
  _, _, full = gtt.sampler.hetero_capacity_plan(ets, lambda et: fan,
                                                {'paper': b}, 'out')
  _, _, cal = gtt.sampler.hetero_capacity_plan(
      ets, lambda et: fan, {'paper': b}, 'out', etype_caps=caps)
  assert all(cal[t] <= full[t] for t in full)
  assert sum(cal.values()) < 0.7 * sum(full.values())
  s = gtt.sampler.NeighborSampler(tg, fan, seed=5, dedup='merge',
                                  frontier_caps=caps, device='cpu')
  rng = np.random.default_rng(1)
  for _ in range(3):
    out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(
        rng.integers(0, 120, b), 'paper'))
    assert not bool(out.metadata['overflow'])
    for t, buf in out.node.items():
      nn_ = int(out.num_nodes[t])
      assert len(set(buf[:nn_].tolist())) == nn_
    for et in out.row:
      stored = gtt.typing.reverse_edge_type(et)
      r, c = out.row[et].numpy(), out.col[et].numpy()
      for j in np.flatnonzero(out.edge_mask[et].numpy()):
        u = int(out.node[et[0]][r[j]])
        v = int(out.node[et[2]][c[j]])
        assert (v, u) in adj[stored], (et, u, v)


def test_hetero_refusals_in_jax_words():
  """The typed engine refuses what JAX's refuses, in its words: an
  explicit key, map_table, padded_window, list caps on a typed graph,
  dict caps on a homogeneous one, an unknown caps edge type, caps under
  tree, an explicit key for typed link sampling."""
  edges, num_nodes, _ = typed_edges()
  _, tg = both_graphs(edges, num_nodes)
  homo = gtt.data.Graph(gtt.data.Topology(edges[CITES], num_nodes=120),
                        device='cpu')
  s = gtt.sampler.NeighborSampler(tg, [2], device='cpu')
  inp = gtt.sampler.NodeSamplerInput(np.arange(4), 'paper')
  with pytest.raises(NotImplementedError, match='homogeneous-only'):
    s.sample_from_nodes(inp, key=gtt.random.PRNGKey(0))
  with pytest.raises(ValueError, match='homogeneous-only'):
    gtt.sampler.NeighborSampler(tg, [2], dedup='map_table',
                                device='cpu').sample_from_nodes(inp)
  with pytest.raises(ValueError, match='homogeneous-only'):
    gtt.sampler.NeighborSampler(tg, [2], padded_window=16, device='cpu')
  with pytest.raises(ValueError, match='homogeneous-only'):
    gtt.sampler.NeighborSampler(tg, [2], dedup='merge', frontier_caps=[4],
                                device='cpu')
  with pytest.raises(ValueError, match='hetero-only'):
    gtt.sampler.NeighborSampler(homo, [2], dedup='merge',
                                frontier_caps={('a', 'b', 'c'): [4]},
                                device='cpu')
  with pytest.raises(ValueError, match='not in'):
    gtt.sampler.NeighborSampler(tg, [2], dedup='merge', device='cpu',
                                frontier_caps={('x', 'y', 'z'): [4]})
  with pytest.raises(ValueError, match='exact-dedup'):
    gtt.sampler.NeighborSampler(tg, [2], dedup='tree', device='cpu',
                                frontier_caps={CITES: [4]})
  with pytest.raises(ValueError, match='homogeneous-only'):
    s.hop_caps(8)
  with pytest.raises(NotImplementedError, match='homogeneous-only'):
    s.sample_from_edges(gtt.sampler.EdgeSamplerInput(
        np.arange(3), np.arange(3), input_type=CITES),
        key=gtt.random.PRNGKey(0))
