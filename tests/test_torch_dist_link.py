"""The port's distributed link sampling against the JAX package's on the
CPU.

Fixtures are ``tests/test_torch_distributed.py``'s: the 40-node ring
(node_pb = v % P) at P = 2 and 4 and a random graph of 300 nodes split
by ``RandomPartitioner``'s rule, plus ``tests/test_distributed.py``'s
near-complete 8-node graph (strict negatives), its all-on-partition-0
ring (an empty shard) and its two-type ring. Both packages see the same
partitions, seed edges and PRNG seed; JAX runs its shard_map programs on
the conftest's CPU mesh, the port a one-process ``ShardMesh``. Held
exactly: ``ops.random_negative_sample_local`` (strict or not, an empty
shard, a span of 2**30 rows reduced by the owned count) and every field
of ``sample_from_edges`` batches, homogeneous and typed, in modes none,
binary and triplet (negatives, the seed union, ``edge_label_index`` /
``edge_label`` / ``src_index`` / ``dst_pos_index`` / ``dst_neg_index``,
the stream position), tree and merge, under ``edge_dir='in'``, with edge
ids and under calibrated caps; and ``DistLinkNeighborLoader``'s batches
with their features. A link batch at ``bucket_frac=None`` reads no
verdict on the host.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.sampler import EdgeSamplerInput as JEdge
from graphlearn_tpu.sampler import NegativeSampling as JNeg
from graphlearn_tpu.typing import GraphPartitionData as JPart
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch.sampler import EdgeSamplerInput as TEdge
from graphlearn_tpu_torch.sampler import NegativeSampling as TNeg
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart

from test_torch_distributed import (N, _np, graphs, jmesh, random_graph,
                                    ring, tmesh)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask',
          'num_sampled_nodes', 'num_sampled_edges')
LINK_MD = ('edge_label_index', 'edge_label', 'src_index', 'dst_pos_index',
           'dst_neg_index', 'seed_mask', 'overflow', 'seed_inverse')


def _eq(a, b, what):
  a, b = np.asarray(a), _np(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  np.testing.assert_array_equal(a, b, err_msg=what)


def assert_link_equal(jo, to, with_edge, what):
  hetero = isinstance(jo.node, dict)
  fields = FIELDS + (('edge',) if with_edge else ())
  for f in fields:
    a, b = getattr(jo, f), getattr(to, f)
    if hetero:
      assert set(a) == set(b), (what, f, sorted(a), sorted(b))
      for k in a:
        _eq(a[k], b[k], f'{what} {f} {k}')
    else:
      _eq(a, b, f'{what} {f}')
  for k in LINK_MD:
    assert (k in jo.metadata) == (k in to.metadata), (what, k)
    if k in jo.metadata:
      _eq(jo.metadata[k], to.metadata[k], f'{what} {k}')
  if not hetero:
    _eq(jo.batch, to.batch, f'{what} batch')


def _neg(mode, k, side):
  return None if mode == 'none' else (JNeg if side == 'j' else TNeg)(mode, k)


# ----------------------------------------------------------------- the op

@pytest.mark.parametrize('strict', [False, True])
def test_random_negative_sample_local_equals_jax(strict):
  import jax
  import jax.numpy as jnp
  jg, tg = graphs(random_graph(3, n=120, deg=8))
  sl = jg.sorted_local_indices()
  for p in range(3):
    for seed in (1, 2):
      key = jax.random.PRNGKey(10 * p + seed)
      want = glt.ops.random_negative_sample_local(
          jnp.asarray(jg.row_ids[p]), jnp.asarray(jg.indptr[p]),
          jnp.asarray(sl[p]), 120, 24, key, strict=strict)
      tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
      args = (torch.as_tensor(tg.row_ids[p]), torch.as_tensor(tg.indptr[p]),
              torch.as_tensor(tg.sorted_local_indices()[p]), 120, 24, tkey)
      got = gtt.ops.random_negative_sample_local(*args, strict=strict)
      plain = gtt.ops.random_negative_sample_local_plain(*args,
                                                         strict=strict)
      for a, b, c in zip(want, got, plain):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c)


def test_random_negative_sample_local_empty_shard_and_counts():
  """A shard owning no row: every slot invalid with ids -1 (JAX's rule);
  the owned count is the rows before the INT32_MAX padding."""
  import jax
  import jax.numpy as jnp
  rid = np.full(6, np.iinfo(np.int32).max, np.int32)
  ptr = np.zeros(7, np.int32)
  ind = np.full(4, -1, np.int32)
  key = jax.random.PRNGKey(3)
  want = glt.ops.random_negative_sample_local(
      jnp.asarray(rid), jnp.asarray(ptr), jnp.asarray(ind), 50, 8, key)
  got = gtt.ops.random_negative_sample_local(
      torch.as_tensor(rid), torch.as_tensor(ptr), torch.as_tensor(ind), 50,
      8, torch.as_tensor(np.asarray(key).astype(np.int64)))
  for a, b in zip(want, got):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
  assert not got[2].any() and (got[0] == -1).all()
  rid[:3] = [2, 5, 9]
  ptr[1:] = [1, 2, 3, 3, 3, 3]
  u, _, _, owned = gtt.ops.negative.local_candidates_plain(
      torch.as_tensor(rid), torch.as_tensor(ptr),
      torch.as_tensor(np.array([4, 4, 4, -1], np.int32)), 50, 64,
      torch.as_tensor([0, 7]))
  assert int(owned) == 3 and int(u.max()) < 3 and int(u.min()) >= 0


# ------------------------------------------------------------ the sampler

LINK_CASES = [
    ('ring2', 'binary', 1, dict()),
    ('ring2', 'triplet', 2, dict(dedup='tree', with_edge=True)),
    ('ring2', 'none', 0, dict(with_edge=True)),
    ('ring4', 'binary', 2, dict(dedup='tree', bucket_frac=None)),
    ('rand4', 'binary', 3, dict(neg_strict=True, with_edge=True)),
    ('rand4', 'triplet', 3, dict(bucket_frac=None, neg_strict=True)),
    ('rand2', 'binary', 2, dict(frontier_caps=[24, 24])),
]
FIX = {'ring2': lambda: ring(2), 'ring4': lambda: ring(4),
       'rand2': lambda: random_graph(2), 'rand4': lambda: random_graph(4)}


def _seed_edges(fixture, p, b, it):
  parts = fixture[0]
  rows = np.concatenate([ei[0] for ei, _, _ in parts])
  cols = np.concatenate([ei[1] for ei, _, _ in parts])
  pick = np.random.default_rng(20 + it).permutation(rows.shape[0])[:p * b]
  return (rows[pick].reshape(p, b).astype(np.int32),
          cols[pick].reshape(p, b).astype(np.int32))


@pytest.mark.parametrize('name,mode,k,kw', LINK_CASES)
def test_sample_from_edges_equals_jax(name, mode, k, kw):
  fixture = FIX[name]()
  p = len(fixture[0])
  jg, tg = graphs(fixture)
  fanouts = [2, 2] if name.startswith('ring') else [3, 2]
  js = glt.distributed.DistNeighborSampler(jg, fanouts, jmesh(p), seed=4,
                                           **kw)
  ts = gdist.DistNeighborSampler(tg, fanouts, tmesh(p), seed=4, **kw)
  b = 4
  gdist.reset_verdict_syncs()
  for it in range(2):
    rows, cols = _seed_edges(fixture, p, b, it)
    mask = np.ones_like(rows, bool)
    mask[-1, -1] = it == 0
    label = (np.arange(p * b).reshape(p, b) % 3 if it else None)
    jo = js.sample_from_edges(JEdge(rows, cols, label=label,
                                    neg_sampling=_neg(mode, k, 'j')),
                              seed_mask=mask)
    to = ts.sample_from_edges(TEdge(rows, cols, label=label,
                                    neg_sampling=_neg(mode, k, 't')),
                              seed_mask=mask)
    assert_link_equal(jo, to, kw.get('with_edge', False), f'{name} {it}')
  assert ts.state_dict() == js.state_dict()
  if kw.get('bucket_frac', 2.0) is None:
    assert gdist.verdict_syncs() == 0


def test_link_negatives_are_shard_local_non_edges_when_strict():
  """The near-complete 8-node graph of ``tests/test_distributed.py``:
  every mask-valid strict negative is a non-edge, and the batches equal
  JAX's."""
  n = 8
  pairs = [(u, v) for u in range(n) for v in range(n)
           if v != u and v != (u + 4) % n]
  rows, cols = np.array(pairs).T
  adj = set(pairs)
  node_pb = (np.arange(n) % 2).astype(np.int32)
  edge_pb = node_pb[rows]
  raw = [(np.stack([rows[edge_pb == p], cols[edge_pb == p]]),
          np.nonzero(edge_pb == p)[0], None) for p in range(2)]
  jg, tg = graphs((raw, None, node_pb, edge_pb))
  seed_r = np.array([[0, 2], [1, 3]], np.int32)
  seed_c = (seed_r + 1) % n
  js = glt.distributed.DistNeighborSampler(jg, [2], jmesh(2), seed=3,
                                           neg_strict=True)
  ts = gdist.DistNeighborSampler(tg, [2], tmesh(2), seed=3, neg_strict=True)
  valid_seen = 0
  for _ in range(4):
    jo = js.sample_from_edges(JEdge(seed_r, seed_c,
                                    neg_sampling=JNeg('binary', 4)))
    to = ts.sample_from_edges(TEdge(seed_r, seed_c,
                                    neg_sampling=TNeg('binary', 4)))
    assert_link_equal(jo, to, False, 'strict')
    node, eli = to.node.numpy(), to.metadata['edge_label_index'].numpy()
    for p in range(2):
      for i in range(2, 6):
        s, d = eli[p, 0, i], eli[p, 1, i]
        if s < 0 or d < 0:
          continue
        valid_seen += 1
        assert (int(node[p][s]), int(node[p][d])) not in adj
  assert valid_seen > 0


def test_link_empty_shard_masks_its_negatives():
  rows = np.arange(N)
  cols = (np.arange(N) + 1) % N
  node_pb = np.zeros(N, np.int32)
  raw = [(np.stack([rows, cols]), np.arange(N), None),
         (np.zeros((2, 0), np.int64), np.zeros((0,), np.int64), None)]
  jg, tg = graphs((raw, None, node_pb, None))
  js = glt.distributed.DistNeighborSampler(jg, [2], jmesh(2), seed=0)
  ts = gdist.DistNeighborSampler(tg, [2], tmesh(2), seed=0)
  seed_r = np.array([[0, 2], [4, 6]], np.int32)
  seed_c = (seed_r + 1) % N
  jo = js.sample_from_edges(JEdge(seed_r, seed_c,
                                  neg_sampling=JNeg('binary', 1)))
  to = ts.sample_from_edges(TEdge(seed_r, seed_c,
                                  neg_sampling=TNeg('binary', 1)))
  assert_link_equal(jo, to, False, 'empty shard')
  eli = to.metadata['edge_label_index'].numpy()
  assert (eli[1, :, 2:] == -1).all() and (eli[0, :, 2:] >= 0).all()
  assert (to.node.numpy() < np.iinfo(np.int32).max).all()


def test_link_in_edge_direction_flips_the_negatives():
  fixture = random_graph(2, n=80)
  parts, _, node_pb, _ = fixture
  # partitions by destination for a CSC: each edge on its dst's owner
  rows = np.concatenate([ei[0] for ei, _, _ in parts])
  cols = np.concatenate([ei[1] for ei, _, _ in parts])
  eids = np.concatenate([e for _, e, _ in parts])
  epb = node_pb[cols]
  raw = [(np.stack([rows[epb == p], cols[epb == p]]), eids[epb == p], None)
         for p in range(2)]
  jp = [JPart(edge_index=ei, eids=e) for ei, e, _ in raw]
  tp = [TPart(edge_index=ei, eids=e) for ei, e, _ in raw]
  jg = glt.distributed.DistGraph(2, 0, jp, node_pb, epb, edge_dir='in')
  tg = gdist.DistGraph(2, 0, tp, node_pb, epb, edge_dir='in')
  js = glt.distributed.DistNeighborSampler(jg, [3], jmesh(2), seed=6)
  ts = gdist.DistNeighborSampler(tg, [3], tmesh(2), seed=6)
  r, c = rows[:8].reshape(2, 4), cols[:8].reshape(2, 4)
  for mode in ('binary', 'triplet'):
    assert_link_equal(
        js.sample_from_edges(JEdge(r, c, neg_sampling=JNeg(mode, 2))),
        ts.sample_from_edges(TEdge(r, c, neg_sampling=TNeg(mode, 2))),
        False, mode)


# ---------------------------------------------------------------- typed

def hetero_ring(num_parts=2):
  """``tests/test_distributed.py``'s two-type ring: ('u','to','v') u_i ->
  v_i, v_{i+1}; ('v','back','u') v_i -> u_{i+2}; u_i on i % P, v_i on
  (i + 1) % P."""
  et1, et2 = ('u', 'to', 'v'), ('v', 'back', 'u')
  ui = np.arange(N)
  e1 = np.stack([np.concatenate([ui, ui]),
                 np.concatenate([ui, (ui + 1) % N])])
  e2 = np.stack([ui, (ui + 2) % N])
  pb = {'u': (ui % num_parts).astype(np.int32),
        'v': ((ui + 1) % num_parts).astype(np.int32)}
  raw = []
  for p in range(num_parts):
    m1 = pb['u'][e1[0]] == p
    m2 = pb['v'][e2[0]] == p
    raw.append({et1: (e1[:, m1], np.nonzero(m1)[0]),
                et2: (e2[:, m2], np.nonzero(m2)[0])})
  return raw, pb, (et1, et2)


def hetero_graphs(raw, pb, **kw):
  jparts = [{et: JPart(edge_index=e, eids=i) for et, (e, i) in r.items()}
            for r in raw]
  tparts = [{et: TPart(edge_index=e, eids=i) for et, (e, i) in r.items()}
            for r in raw]
  p = len(raw)
  return (glt.distributed.DistHeteroGraph(p, 0, jparts, pb, **kw),
          gdist.DistHeteroGraph(p, 0, tparts, pb, **kw))


@pytest.mark.parametrize('mode,kw', [
    ('binary', dict()), ('triplet', dict(dedup='tree', with_edge=True)),
    ('none', dict(bucket_frac=None)),
    ('binary', dict(neg_strict=True, bucket_frac=0.25))])
def test_typed_sample_from_edges_equals_jax(mode, kw):
  raw, pb, (et1, et2) = hetero_ring(2)
  jg, tg = hetero_graphs(raw, pb)
  fan = {et1: [2, 1], et2: [1, 1]}
  js = glt.distributed.DistNeighborSampler(jg, fan, jmesh(2), seed=0, **kw)
  ts = gdist.DistNeighborSampler(tg, fan, tmesh(2), seed=0, **kw)
  rows = np.array([[0, 4, 8], [1, 5, 9]], np.int32)
  for it in range(2):
    r = (rows + it) % N
    jo = js.sample_from_edges(JEdge(r, r, input_type=et1,
                                    neg_sampling=_neg(mode, 2, 'j')))
    to = ts.sample_from_edges(TEdge(r, r, input_type=et1,
                                    neg_sampling=_neg(mode, 2, 't')))
    assert to.input_type == et1
    assert_link_equal(jo, to, kw.get('with_edge', False), f'{mode} {it}')
  assert ts.state_dict() == js.state_dict()


def test_typed_link_one_node_type_unions_both_sides():
  """A seed edge type whose endpoints share a node type: both sides seed
  one set (``src_t == dst_t``)."""
  rng = np.random.default_rng(5)
  n = 60
  et = ('p', 'cites', 'p')
  e = np.stack([rng.integers(0, n, 240), rng.integers(0, n, 240)])
  pb = {'p': (np.arange(n) % 2).astype(np.int32)}
  raw = [{et: (e[:, pb['p'][e[0]] == q], np.nonzero(pb['p'][e[0]] == q)[0])}
         for q in range(2)]
  jg, tg = hetero_graphs(raw, pb)
  js = glt.distributed.DistNeighborSampler(jg, [3, 2], jmesh(2), seed=8)
  ts = gdist.DistNeighborSampler(tg, [3, 2], tmesh(2), seed=8)
  r, c = e[0, :8].reshape(2, 4), e[1, :8].reshape(2, 4)
  for mode in ('binary', 'triplet'):
    assert_link_equal(
        js.sample_from_edges(JEdge(r, c, input_type=et,
                                   neg_sampling=JNeg(mode, 3))),
        ts.sample_from_edges(TEdge(r, c, input_type=et,
                                   neg_sampling=TNeg(mode, 3))),
        False, mode)


# ----------------------------------------------------------------- loader

@pytest.mark.parametrize('kw', [
    dict(batch_size=4, shuffle=True, seed=0, mode='binary'),
    dict(batch_size=3, seed=1, drop_last=False, mode='triplet',
         dedup='tree', bucket_frac=None),
    dict(batch_size=4, seed=2, mode='none', labels=True)])
def test_dist_link_loader_equals_jax(kw):
  kw = dict(kw)
  mode = kw.pop('mode')
  with_labels = kw.pop('labels', False)
  fixture = ring(2)
  parts, feats, node_pb, _ = fixture
  jg, tg = graphs(fixture)
  jds = glt.distributed.DistDataset(
      2, 0, jg, glt.distributed.DistFeature(2, feats, node_pb, jmesh(2)))
  tds = gdist.DistDataset(2, 0, tg,
                          gdist.DistFeature(2, feats, node_pb, tmesh(2)))
  seeds = np.stack([np.arange(N), (np.arange(N) + 1) % N])
  label = np.arange(N) % 5 if with_labels else None
  jl = glt.distributed.DistLinkNeighborLoader(
      jds, [2, 2], seeds, edge_label=label, mesh=jmesh(2),
      neg_sampling=_neg(mode, 1, 'j'), **kw)
  tl = gdist.DistLinkNeighborLoader(
      tds, [2, 2], seeds, edge_label=label, mesh=tmesh(2),
      neg_sampling=_neg(mode, 1, 't'), **kw)
  assert len(tl) == len(jl) > 0
  steps = 0
  for jb, tb in zip(jl, tl):
    steps += 1
    for f in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x'):
      _eq(getattr(jb, f), getattr(tb, f), f)
    for k in LINK_MD:
      if k in jb.metadata:
        _eq(jb.metadata[k], tb.metadata[k], k)
    valid = tb.node >= 0
    assert torch.equal(tb.x[..., 0][valid], tb.node[valid].float())
  assert steps == len(tl)
