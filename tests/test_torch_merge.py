"""The port's merge (exact-dedup) path against the JAX package, on the CPU.

Inputs come from numpy with a seed. The JAX level kernel runs through
the Pallas interpreter (``interpret=True``), as the JAX package's own
tests run it. Ids, masks, counts, caps, overflow flags and sorted views
are compared exactly; logits within atol=1e-5, rtol=1e-4 (the two
frameworks sum in other orders). The level kernel's plain version, which
the kernel is held to on the card, is also held to the merge inducer
here at shapes the TPU kernel refuses (S > 32768).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
from graphlearn_tpu import ops as jops
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu.ops import sample_fused as jsf
from graphlearn_tpu.sampler import calibrate as jcal
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops as tops
from graphlearn_tpu_torch import random as trandom
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.sampler import calibrate as tcal

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

FILL = tops.FILL
STATE_FIELDS = ('nodes', 'num_nodes', 'sorted_ids', 'sorted_loc')


def _t(a):
  return torch.as_tensor(np.array(a))


def _eq(a, b, what=''):
  np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                err_msg=what)


def _tstate(st):
  return tops.MergeInducerState(*(_t(f).clone() for f in st))


@pytest.mark.parametrize('n,size,frac', [(40, 40, 0.7), (25, 8, 0.9),
                                         (12, 12, 0.0)])
def test_masked_unique_matches_jax(n, size, frac):
  rng = np.random.default_rng(n)
  ids = rng.integers(0, 15, n).astype(np.int32)
  mask = rng.random(n) < frac
  ref = jops.masked_unique(jnp.asarray(ids), jnp.asarray(mask), size=size)
  got = tops.masked_unique(_t(ids), _t(mask), size)
  for a, b in zip(ref, got):
    _eq(a, b)


@pytest.mark.parametrize('max_new', [None, 'tight'])
def test_induce_next_merge_matches_jax(max_new):
  """Mirrors tests/test_ops.py's merge-inducer check: seeds with
  duplicates and masked slots, then two hops of candidates, one of them
  truncated by ``max_new``; every output and the whole state, sorted view
  included, bit-exact."""
  rng = np.random.default_rng(7)
  n, f, k1, k2 = 60, 10, 4, 3
  seeds = rng.integers(0, n, f).astype(np.int32)
  seeds[3] = seeds[1]
  smask = np.arange(f) < 8
  cap = f + f * k1 + f * k1 * k2
  jst, juniq, jm, jinv = jops.init_node_merge(jnp.asarray(seeds),
                                              jnp.asarray(smask), cap)
  tst, tuniq, tm, tinv = tops.init_node_merge(_t(seeds), _t(smask), cap)
  for name, a, b in zip(STATE_FIELDS, jst, tst):
    _eq(a, b, name)
  for a, b in ((juniq, tuniq), (jm, tm), (jinv, tinv)):
    _eq(a, b)
  fidx = np.arange(f, dtype=np.int32)
  h1 = rng.integers(0, n, (f, k1)).astype(np.int32)
  m1 = (rng.random((f, k1)) < 0.8) & np.asarray(jm)[:, None]
  mn1 = 11 if max_new == 'tight' else None
  jst, jout = jops.induce_next_merge(jst, jnp.asarray(fidx), jnp.asarray(h1),
                                     jnp.asarray(m1), prefix_cap=f,
                                     max_new=mn1)
  tst, tout = tops.induce_next_merge(tst, _t(fidx), _t(h1), _t(m1),
                                     prefix_cap=f, max_new=mn1)
  for name, a, b in zip(STATE_FIELDS, jst, tst):
    _eq(a, b, name)
  for name in jout:
    _eq(jout[name], tout[name], name)
  if max_new == 'tight':
    assert int(tout['num_new']) > mn1     # the hop overflowed
  w = f * k1
  h2 = rng.integers(0, n, (w, k2)).astype(np.int32)
  m2 = (rng.random((w, k2)) < 0.8) & np.asarray(jout['frontier_mask'])[:,
                                                                       None]
  pc2 = f + (mn1 or w)
  jst, jout = jops.induce_next_merge(
      jst, jout['frontier_idx'], jnp.asarray(h2), jnp.asarray(m2),
      prefix_cap=pc2, update_view=False)
  tst, tout = tops.induce_next_merge(
      tst, tout['frontier_idx'], _t(h2), _t(m2), prefix_cap=pc2,
      update_view=False)
  for name, a, b in zip(STATE_FIELDS, jst, tst):
    _eq(a, b, name)
  for name in jout:
    _eq(jout[name], tout[name], name)


def test_sample_level_matches_interpret_kernel():
  """16 seeds x k = 4 against the JAX level kernel in the interpreter: a
  hub above the 128-wide window, a deg-0 node, masked seeds, a prefix
  that already holds some picks, and a limit that truncates. The port's
  CPU route (JAX's fallback) equals the JAX kernel route on every state
  field and output; the plain version of the port's kernel equals the JAX
  kernel's raw outputs (``cols_raw`` compared where valid: the TPU kernel
  writes a prefix hit's position even at masked slots, the port -1)."""
  rng = np.random.default_rng(3)
  n = 70
  rows = np.concatenate([np.full(300, 5), rng.integers(1, n, 900)])
  cols = rng.integers(0, n, rows.shape[0])
  rows[rows == n - 1] = 1               # node n-1 has degree 0
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=n)
  ip, ind = topo.indptr.astype(np.int32), topo.indices
  meta = np.stack([ip[:-1], ip[1:] - ip[:-1]], 1).astype(np.int32)
  window = 128
  blocks = jops.build_indices128(jnp.asarray(ind),
                                 min_rows=window // 128 + 1)
  f, k = 16, 4
  seeds = np.concatenate([[5, n - 1], rng.integers(0, n, f - 2)]).astype(
      np.int32)
  smask = np.arange(f) < 14
  cap = 120
  jst, _, jm, _ = jops.init_node_merge(jnp.asarray(seeds),
                                       jnp.asarray(smask), cap)
  tst, _, tm, _ = tops.init_node_merge(_t(seeds), _t(smask), cap)
  fidx = np.arange(f, dtype=np.int32)
  jkey = jax.random.fold_in(jax.random.PRNGKey(2), 9)
  tkey = trandom.fold_in(trandom.PRNGKey(2), 9)
  uniq = np.asarray(jst.nodes)[:f]
  for max_new in (None, 20):
    jst2, jout, jep, jmk = jsf.sample_level_fused(
        jnp.asarray(ip), jnp.asarray(ind), blocks, jnp.asarray(uniq),
        jnp.asarray(jm), k, jkey, jst, jnp.asarray(fidx),
        meta=jnp.asarray(meta), prefix_cap=f, max_new=max_new,
        window=window, block_seeds=8, interpret=True)
    tst2, tout, tep, tmk = tops.sample_level_fused(
        _t(ip), _t(ind), None, _t(uniq), tm, k, tkey, _tstate(tst),
        _t(fidx), meta=_t(meta), prefix_cap=f, max_new=max_new)
    _eq(jep, tep, 'epos')
    _eq(jmk, tmk, 'mask')
    for name in ('nodes', 'num_nodes'):
      _eq(getattr(jst2, name), getattr(tst2, name), name)
    for name in jout:
      _eq(jout[name], tout[name], name)
    limit = min(f * k, cap - f, max_new or f * k)
    jcols, jblock, jnew = jsf._level_pallas(
        blocks, jnp.asarray(meta[np.where(np.asarray(jm), uniq, 0)][:, 0]),
        jnp.asarray(meta[np.where(np.asarray(jm), uniq, 0)][:, 1]), jep,
        jmk, jst.nodes[:f], jst.num_nodes, k, limit, window, 8, True)
    picked, cols_raw, block, num_new = tops.sample_level_plain(
        _t(ind), tep, tmk, tst.nodes[:f], tst.num_nodes, limit, n)
    valid = np.asarray(jmk).reshape(-1)
    _eq(np.where(valid, np.asarray(jcols), -1), cols_raw, 'cols_raw')
    _eq(jblock, block, 'block')
    _eq(jnew, num_new, 'num_new')
    _eq(np.asarray(ind)[np.asarray(jep).reshape(-1)], picked, 'picked')
    if max_new:
      assert int(num_new) > max_new       # the level overflowed
  assert tops.launch_counts()['sample_level'] == 0


def _popc(words):
  """Set bits of each 32-bit word (int64 tensor)."""
  return ((words[..., None] >> torch.arange(32)) & 1).sum(-1)


class _LevelPlan:
  """A torch emulation of the level kernel's launches
  (``csrc/sample_level.cu``), step for step: the node-id table carried
  across the batch's levels (a dense id -> position map here, the same
  function as the kernel's hash table), the id bitmap that each scan
  copies and leaves clear, ranks by popcount, and only kept new ids
  inserted, at ``num_nodes + rank``."""

  def __init__(self, n):
    self.n = n
    self.table = torch.full((n,), -1, dtype=torch.int64)
    self.bitmap = torch.zeros((n + 31) // 32, dtype=torch.int64)

  def begin(self, nodes, num_nodes, prefix_len):
    self.table.fill_(-1)
    self.bitmap.zero_()
    m = min(prefix_len, int(num_nodes))
    pre = nodes[:m].long()
    ok = pre >= 0
    self.table[pre[ok]] = torch.arange(m)[ok]

  def pick(self, picks, valid, src_idx, k):
    v = picks.long()
    inside = valid & (v >= 0) & (v < self.n)
    pos = torch.where(inside, self.table[v.clamp(0, self.n - 1)], -1)
    found = inside & (pos >= 0)
    new = inside & ~found
    hit = torch.zeros(self.bitmap.shape[0] * 32, dtype=torch.int64)
    hit[v[new]] = 1
    assert not bool((self.bitmap & _pack(hit)).any()), 'bitmap not clear'
    self.bitmap |= _pack(hit)
    b = torch.arange(v.numel()) // max(k, 1)
    cols = torch.where(found, pos, torch.where(new, -2 - v, -1))
    rows = torch.where(found, src_idx.long()[b], -1)
    return cols, rows, found.clone()

  def scan(self, num_nodes, limit):
    pc = _popc(self.bitmap)
    self.base = torch.cumsum(pc, 0) - pc
    self.copy = self.bitmap.clone()
    self.bitmap.zero_()               # clear for the next level
    num_new = int(pc.sum())
    return num_new, int(num_nodes) + min(num_new, limit)

  def resolve(self, cols, rows, emask, src_idx, k, nodes, num_nodes,
              num_new, limit, insert):
    size = cols.numel()
    nn = int(num_nodes)
    kept = min(num_new, limit)
    parked = cols <= -2
    i = torch.nonzero(parked).reshape(-1)
    v = -2 - cols[i]
    w = v >> 5
    r = self.base[w] + _popc(self.copy[w] & ((1 << (v & 31)) - 1))
    keep = r < limit
    cols[i] = torch.where(keep, nn + r, -1)
    rows[i] = torch.where(keep, src_idx.long()[i // k], -1)
    emask[i] = keep
    nodes[nn:nn + limit] = FILL
    nodes[nn + r[keep]] = v[keep].to(nodes.dtype)
    frontier = torch.full((size,), FILL, dtype=torch.int64)
    frontier[r[keep]] = v[keep]
    ar = torch.arange(size)
    if insert:
      self.table[v[keep]] = nn + r[keep]
    return dict(rows=rows, cols=cols, edge_mask=emask, frontier=frontier,
                frontier_idx=torch.where(ar < kept, nn + ar, -1),
                frontier_mask=ar < kept, num_new=num_new)

  def level(self, picks, valid, src_idx, k, nodes, num_nodes, limit,
            final):
    """pick, scan, resolve: ``(out, num_nodes')``."""
    cols, rows, emask = self.pick(picks, valid, src_idx, k)
    num_new, nn2 = self.scan(num_nodes, limit)
    out = self.resolve(cols, rows, emask, src_idx, k, nodes, num_nodes,
                       num_new, limit, not final)
    return out, nn2


def _pack(bits):
  """[32 * W] 0/1 -> [W] 32-bit words (int64)."""
  return (bits.reshape(-1, 32) << torch.arange(32)).sum(1)


@pytest.mark.parametrize('case', ['wide', 'all_found', 'all_masked',
                                  'empty'])
def test_level_plain_route_matches_merge_inducer(case):
  """The level kernel's plan (``_LevelPlan``: pick, scan and resolve over
  the carried table) equals the merge inducer (the CPU route) on nodes,
  counts and every output, at S = 2048 x 20 = 40,960 candidates (above
  the TPU kernel's 32,768) with heavy duplicates, hubs and truncation;
  and on a level whose picks are all in the prefix, all masked, or
  empty."""
  rng = np.random.default_rng(11)
  n = 3000
  f, k = (2048, 20) if case != 'empty' else (0, 5)
  nbrs = rng.integers(0, 400, (f, k)).astype(np.int32)   # many repeats
  nbrs[::7] = rng.integers(0, n, (nbrs[::7].shape[0], k))
  mask = rng.random((f, k)) < 0.9
  seeds = np.arange(512, dtype=np.int32) * 5
  if case == 'all_found':
    nbrs = seeds[rng.integers(0, 500, (f, k))]
  if case == 'all_masked':
    mask[:] = False
  prefix = 512 + 100
  cap = prefix + 20000
  st0, _, _, _ = tops.init_node_merge(_t(seeds), torch.ones(512, dtype=bool),
                                      cap)
  # a second hop's state: 100 more nodes appended above the seeds
  extra = (np.arange(100, dtype=np.int32) * 5 + 1).reshape(100, 1)
  st0, _ = tops.induce_next_merge(
      st0, torch.arange(100, dtype=torch.int32), _t(extra),
      torch.ones((100, 1), dtype=bool), prefix_cap=512)
  src = torch.arange(f, dtype=torch.int32)
  for max_new in (None, 900):
    limit = min(f * k, cap - prefix, max_new or f * k)
    ref_st, ref = tops.induce_next_merge(
        _tstate(st0), src, torch.where(_t(mask), _t(nbrs), -1), _t(mask),
        prefix_cap=prefix, max_new=max_new, update_view=False)
    st = _tstate(st0)
    plan = _LevelPlan(n)
    plan.begin(st.nodes, st.num_nodes, prefix)
    got, nn2 = plan.level(_t(nbrs.reshape(-1)), _t(mask.reshape(-1)), src,
                          k, st.nodes, st.num_nodes, limit, final=False)
    _eq(ref_st.nodes, st.nodes, 'nodes')
    assert int(ref_st.num_nodes) == nn2
    for name in ref:
      _eq(ref[name], torch.as_tensor(got[name]), name)
    assert not bool(plan.bitmap.any())          # the scan cleared it
    if case == 'wide' and max_new:
      assert got['num_new'] > max_new
  assert tops.launch_counts()['sample_level'] == 0


@pytest.mark.parametrize('caps', [[40, 70, 90], [16 * 4, 16 * 12, 16 * 36]])
def test_level_plan_chain_matches_jax_merge_chain(caps):
  """Three levels of one merge batch through ``_LevelPlan`` (one begin,
  the table carried from level to level) equal the JAX sampler's
  ``uniform_sample`` + ``induce_next_merge`` chain and its batch exactly,
  with ``max_new`` truncating the levels under tight caps."""
  ei, rng = _graph(seed=8, n=300, e=5000, hub=9)
  n, fanouts, b = 300, [4, 3, 3], 16
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  js = glt.sampler.NeighborSampler(jg, fanouts, seed=3, dedup='merge',
                                   frontier_caps=caps)
  seeds = np.concatenate([[9, n - 1, 9], rng.integers(0, n, 10)])
  padded = np.zeros(b, np.int32)
  padded[:seeds.size] = seeds
  smask = np.arange(b) < seeds.size
  jkey = jax.random.fold_in(jax.random.PRNGKey(3), 1)
  hop_caps = js.hop_caps(b)
  node_offs, _ = glt.sampler.neighbor_sampler.merge_layout_from_caps(
      hop_caps, fanouts)
  ip, ind = jnp.asarray(jg.indptr), jnp.asarray(jg.indices)
  jst, jfr, jfm, _ = jops.init_node_merge(jnp.asarray(padded),
                                          jnp.asarray(smask), sum(hop_caps))
  tst, tfr, tfm, _ = tops.init_node_merge(_t(padded), _t(smask),
                                          sum(hop_caps))
  plan = _LevelPlan(n)
  plan.begin(tst.nodes, tst.num_nodes, b)
  jidx = jnp.arange(b, dtype=jnp.int32)
  tidx = torch.arange(b, dtype=torch.int32)
  jkeys = jax.random.split(jkey, len(fanouts))
  tkeys = trandom.split(trandom.fold_in(trandom.PRNGKey(3), 1), len(fanouts))
  overflowed = False
  for i, k in enumerate(fanouts):
    final = i + 1 == len(fanouts)
    jn, _, jm = jops.uniform_sample(ip, ind, jfr, jfm, k, jkeys[i])
    tn, _, tm = tops.uniform_sample(tg.indptr, tg.indices, tfr, tfm, k,
                                    tkeys[i])
    _eq(jn, tn, 'picks')
    jst, jout = jops.induce_next_merge(jst, jidx, jn, jm,
                                       prefix_cap=node_offs[i],
                                       max_new=hop_caps[i + 1],
                                       update_view=not final)
    size, cap = tfr.shape[0] * k, tst.nodes.shape[0]
    limit = min(size, cap - min(node_offs[i], cap), hop_caps[i + 1])
    tout, nn2 = plan.level(tn.reshape(-1), tm.reshape(-1), tidx, k,
                           tst.nodes, tst.num_nodes, limit, final)
    tst = tops.MergeInducerState(tst.nodes, torch.tensor(nn2, dtype=torch.int32),
                                 tst.sorted_ids, tst.sorted_loc)
    for name in jout:
      _eq(jout[name], torch.as_tensor(tout[name]), f'level {i} {name}')
    _eq(jst.nodes, tst.nodes, f'level {i} nodes')
    _eq(jst.num_nodes, tst.num_nodes, f'level {i} num_nodes')
    overflowed |= tout['num_new'] > hop_caps[i + 1]
    nxt = hop_caps[i + 1]
    jfr, jidx, jfm = (jout[x][:nxt] for x in
                      ('frontier', 'frontier_idx', 'frontier_mask'))
    tfr = tout['frontier'][:nxt].to(torch.int32)
    tidx = tout['frontier_idx'][:nxt].to(torch.int32)
    tfm = tout['frontier_mask'][:nxt]
  assert overflowed == (caps[0] == 40)     # the tight caps truncate
  whole = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds),
                               batch_cap=b, key=jkey)
  _eq(whole.node, tst.nodes, 'the JAX batch nodes')
  _eq(whole.num_nodes, tst.num_nodes, 'the JAX batch num_nodes')


def _graph(seed=6, n=200, e=3000, hub=7):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, e)
  rows[:300] = hub
  cols = rng.integers(0, n, e)
  return np.stack([rows, cols]), rng


def _fields(out, to_np):
  f = {name: to_np(getattr(out, name))
       for name in ('node', 'row', 'col', 'edge_mask', 'num_nodes', 'batch')}
  f['batch_size'] = out.batch_size
  f['edge'] = out.edge
  f['num_sampled_nodes'] = [int(c) for c in out.num_sampled_nodes]
  f['num_sampled_edges'] = [int(c) for c in out.num_sampled_edges]
  f['overflow'] = bool(out.metadata['overflow'])
  f['seed_inverse'] = to_np(out.metadata['seed_inverse'])
  f['seed_mask'] = np.asarray(out.metadata['seed_mask'])
  return f


def test_merge_sampler_stream_matches_jax():
  """3 batches (two padded to 16, one rounded up), frontier_caps tight
  enough that some batches overflow: every field, the overflow flags and
  the call counters equal the JAX merge sampler's."""
  ei, rng = _graph()
  n = 200
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  caps = [40, 60]
  js = glt.sampler.NeighborSampler(jg, [4, 3], seed=11, dedup='merge',
                                   frontier_caps=caps)
  ts = gtt.sampler.NeighborSampler(tg, [4, 3], seed=11, dedup='merge',
                                   frontier_caps=caps, device='cpu')
  assert ts.hop_caps(16) == js.hop_caps(16) == [16, 40, 60]
  assert ts.clamped_exact and js.clamped_exact
  flags = []
  for step in range(3):
    seeds = np.concatenate([[7, n - 1, 7], rng.integers(0, n, 11)])
    cap = 16 if step < 2 else None
    a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap)
    b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap)
    fa, fb = _fields(a, np.asarray), _fields(b, lambda t: t.numpy())
    for name in fa:
      np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
    flags.append(fb['overflow'])
    assert jcal.check_no_overflow(js, a) == tcal.check_no_overflow(ts, b)
  assert any(flags)
  assert ts._call_count == js._call_count == 3
  full = ts.uncapped_clone()
  assert full.frontier_caps is None and ts.frontier_caps == (40, 60)


@pytest.mark.parametrize('pool', [None, 'pool'])
def test_estimate_frontier_caps_matches_jax(pool):
  ei, rng = _graph(seed=4, n=500, e=6000, hub=3)
  n = 500
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  inp = rng.permutation(n)[:150] if pool else None
  ref = jcal.estimate_frontier_caps(jg, [5, 4, 3], 32, input_nodes=inp,
                                    num_probes=4, seed=9, multiple=16)
  got = tcal.estimate_frontier_caps(tg, [5, 4, 3], 32, input_nodes=inp,
                                    num_probes=4, seed=9, multiple=16)
  assert got == ref and len(got) == 3


def _datasets(ei, n, feats, labels):
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  jds.init_node_features(feats)
  jds.init_node_labels(labels)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=n)
  tds.init_node_features(feats)
  tds.init_node_labels(labels)
  return jds, tds


@pytest.mark.parametrize('caps', [None, [12, 16]])
def test_merge_dense_forward_matches_flax(caps):
  """GraphSAGE(merge_dense=True) with the flax weights carried across, on
  a merge batch whose seed block leads with a zero-degree seed (mirrors
  tests/test_models.py's merge-dense checks), with and without caps."""
  rng = np.random.default_rng(3)
  n = 200
  ei = np.stack([rng.integers(1, n, 2000), rng.integers(1, n, 2000)])
  feats = rng.standard_normal((n, 8)).astype(np.float32)
  labels = rng.integers(0, 3, n).astype(np.int32)
  jds, tds = _datasets(ei, n, feats, labels)
  seeds = np.array([0, 5, 9, 13, 21, 34, 55, 89])
  kw = dict(batch_size=8, seed=0, frontier_caps=caps, overflow_policy='off')
  jb = next(iter(glt.loader.NeighborLoader(jds, [3, 2], seeds, dedup='map',
                                           **kw)))
  tb = next(iter(gtt.loader.NeighborLoader(tds, [3, 2], seeds, device='cpu',
                                           **kw)))
  jd, td = jtrain.batch_to_dict(jb), ttrain.batch_to_dict(tb)
  for key in ('x', 'edge_index', 'edge_mask', 'y'):
    _eq(jd[key], td[key], key)
  no, eo = jtrain.merge_hop_offsets(8, [3, 2], frontier_caps=caps)
  assert (no, eo) == ttrain.merge_hop_offsets(8, [3, 2], frontier_caps=caps)
  jmodel = JaxSAGE(hidden_dim=16, out_dim=3, num_layers=2,
                   hop_node_offsets=no, hop_edge_offsets=eo,
                   merge_dense=True, fanouts=(3, 2))
  params = jmodel.init(jax.random.PRNGKey(1), jd['x'], jd['edge_index'],
                       jd['edge_mask'])
  tmodel = gtt.models.GraphSAGE(8, 16, 3, num_layers=2, hop_node_offsets=no,
                                hop_edge_offsets=eo, merge_dense=True,
                                fanouts=[3, 2], device='cpu')
  tmodel.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  ref = np.asarray(jtrain.make_forward_fn(jmodel)(params, jd))
  with torch.no_grad():
    got = ttrain.make_forward_fn(tmodel)(td).numpy()
  assert got.shape == ref.shape == (no[1], 3)
  np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
  jc, jt = jtrain.make_eval_counts(jmodel)(params, jd)
  tc, tt = ttrain.make_eval_counts(tmodel)(td)
  assert (int(jc), int(jt)) == (int(tc), int(tt)) and int(tt) == 8


@pytest.mark.parametrize('shuffle', [False, True])
def test_merge_slice_matches_jax(shuffle):
  """Dataset -> NeighborLoader(dedup='auto', frontier_caps='auto') ->
  collate -> merge_dense forward -> eval counts, batch for batch against
  the JAX loader (caps calibrated in both from the same pool)."""
  rng = np.random.default_rng(0)
  n, f, c = 300, 16, 5
  e = 2400
  rows = rng.integers(0, n, e)
  cols = np.empty(e, np.int64)
  cols[:e // 2] = rng.integers(0, n, e // 2)
  cols[e // 2:] = rng.zipf(1.5, e - e // 2) % n
  feats = rng.standard_normal((n, f)).astype(np.float32)
  labels = rng.integers(0, c, n).astype(np.int32)
  seeds = rng.permutation(n)[:56]       # 3 full batches + a ragged tail
  jds, tds = _datasets(np.stack([rows, cols]), n, feats, labels)
  kw = dict(batch_size=16, shuffle=shuffle, seed=3, frontier_caps='auto')
  jl = glt.loader.NeighborLoader(jds, [4, 3], seeds, dedup='auto', **kw)
  tl = gtt.loader.NeighborLoader(tds, [4, 3], seeds, device='cpu', **kw)
  caps = tl.sampler.frontier_caps
  assert caps == jl.sampler.frontier_caps and tl.sampler.clamped_exact
  no, eo = ttrain.merge_hop_offsets(16, [4, 3], frontier_caps=caps)
  jmodel = JaxSAGE(hidden_dim=32, out_dim=c, num_layers=2,
                   hop_node_offsets=no, hop_edge_offsets=eo,
                   merge_dense=True, fanouts=(4, 3))
  tmodel = gtt.models.GraphSAGE(f, 32, c, num_layers=2, hop_node_offsets=no,
                                hop_edge_offsets=eo, merge_dense=True,
                                fanouts=[4, 3], device='cpu')
  params = None
  n_batches = 0
  for jb, tb in zip(jl, tl):
    jd, td = jtrain.batch_to_dict(jb), ttrain.batch_to_dict(tb)
    for key in ('x', 'edge_index', 'edge_mask', 'y'):
      _eq(jd[key], td[key], key)
    _eq(jb.node, tb.node, 'node')
    assert int(jd['num_seed_nodes']) == int(td['num_seed_nodes'])
    if params is None:
      params = jmodel.init(jax.random.PRNGKey(0), jd['x'],
                           jd['edge_index'], jd['edge_mask'])
      tmodel.load_state_dict(convert.params_from_flax(
          jax.tree.map(np.asarray, params)))
    ref = np.asarray(jmodel.apply(params, jd['x'], jd['edge_index'],
                                  jd['edge_mask']))
    with torch.no_grad():
      got = ttrain.make_forward_fn(tmodel)(td).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    jc, jt = jtrain.make_eval_counts(jmodel)(params, jd)
    tc, tt = ttrain.make_eval_counts(tmodel)(td)
    assert (int(jc), int(jt)) == (int(tc), int(tt))
    n_batches += 1
  assert n_batches == len(tl) == len(jl) == 4
  assert not tl.check_overflow()


def test_overflow_guard_policies():
  """Under caps that overflow: 'raise' raises at epoch end, 'warn'
  warns, 'recompute' yields the uncapped batch of the same key, 'off'
  stays silent; check_overflow reads the accumulated flag."""
  ei, _ = _graph(seed=1, n=60, e=600, hub=2)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=60)
  tds.init_node_features(np.eye(60, 4, dtype=np.float32))

  def mk(**kw):
    return gtt.loader.NeighborLoader(tds, [2, 2], np.arange(16),
                                     batch_size=4, seed=0, device='cpu',
                                     **kw)

  with pytest.raises(RuntimeError, match='frontier_caps overflowed'):
    for _ in mk(frontier_caps=[1, 1]):
      pass
  with pytest.warns(UserWarning, match='frontier_caps overflowed'):
    for _ in mk(frontier_caps=[1, 1], overflow_policy='warn'):
      pass
  early = mk(frontier_caps=[1, 1])
  next(iter(early))
  assert early.check_overflow()
  fix = mk(frontier_caps=[1, 1], overflow_policy='recompute')
  ref = mk()
  steps = 0
  for got, want in zip(fix, ref):
    steps += 1
    for name in ('node', 'edge_index', 'edge_mask', 'x'):
      torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                 rtol=0, atol=0)
  assert steps == len(ref) == fix.overflow_recomputes == 4
  for _ in mk(frontier_caps=[1, 1], overflow_policy='off'):
    pass
  with pytest.raises(ValueError, match='overflow_policy'):
    mk(overflow_policy='sometimes')
  with pytest.raises(ValueError, match='exact-dedup'):
    mk(dedup='tree', frontier_caps=[4, 4])
