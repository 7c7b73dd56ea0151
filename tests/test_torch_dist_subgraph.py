"""The port's distributed induced subgraphs against the JAX package's on
the CPU.

Fixtures are ``tests/test_torch_distributed.py``'s 40-node ring at P = 2
and 4 and its 300-node random graph. Both packages see the same
partitions, seeds and PRNG seed; JAX runs its shard_map program (an
optional hop expansion, ``masked_unique``, an ``all_gather`` of every
shard's node keys, ``node_subgraph_local`` per gathered set, an
``all_to_all`` back) on the conftest's CPU mesh, the port the same steps
on a one-process ``ShardMesh`` (the gather a broadcast of the ``[P,
cap]`` keys). Held exactly: ``ops.node_subgraph_local``, every field of
``subgraph`` batches with the seeds' ``mapping`` and edge ids, with and
without a hop expansion and under an explicit ``max_degree``; and
``DistSubGraphLoader``'s batches with their features.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import distributed as gdist

from test_torch_distributed import (N, _np, graphs, jmesh, random_graph,
                                    ring, tmesh)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask')


def _eq(a, b, what):
  a, b = np.asarray(a), _np(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  np.testing.assert_array_equal(a, b, err_msg=what)


def test_node_subgraph_local_equals_jax():
  import jax.numpy as jnp
  jg, tg = graphs(random_graph(3, n=90))
  rng = np.random.default_rng(2)
  big = np.iinfo(np.int32).max
  for p in range(3):
    for md in (3, 9):
      keys = np.sort(rng.choice(90, 24, replace=False)).astype(np.int32)
      keys[-5:] = big
      want = glt.ops.node_subgraph_local(
          jnp.asarray(jg.row_ids[p]), jnp.asarray(jg.indptr[p]),
          jnp.asarray(jg.indices[p]), jnp.asarray(keys), md)
      got = gtt.ops.node_subgraph_local(
          torch.as_tensor(tg.row_ids[p]), torch.as_tensor(tg.indptr[p]),
          torch.as_tensor(tg.indices[p]), torch.as_tensor(keys), md)
      for k in want:
        _eq(want[k], got[k], k)


SUB_CASES = [
    ('ring2', None, dict(with_edge=True)),
    ('ring4', [2], dict()),
    ('rand4', [3, 2], dict(with_edge=True)),
    ('rand2', [2], dict(bucket_frac=None, max_degree=4)),
]
FIX = {'ring2': lambda: ring(2), 'ring4': lambda: ring(4),
       'rand2': lambda: random_graph(2), 'rand4': lambda: random_graph(4)}


@pytest.mark.parametrize('name,fanouts,kw', SUB_CASES)
def test_subgraph_equals_jax(name, fanouts, kw):
  kw = dict(kw)
  max_degree = kw.pop('max_degree', None)
  fixture = FIX[name]()
  p = len(fixture[0])
  n = fixture[2].shape[0]
  jg, tg = graphs(fixture)
  js = glt.distributed.DistNeighborSampler(jg, fanouts, jmesh(p), seed=3,
                                           **kw)
  ts = gdist.DistNeighborSampler(tg, fanouts, tmesh(p), seed=3, **kw)
  b = 4 if fanouts else 6
  for it in range(2):
    seeds = np.random.default_rng(it).permutation(n)[:p * b].reshape(
        p, b).astype(np.int32)
    seeds[0, 1] = seeds[0, 0]                   # a repeated seed
    mask = np.ones_like(seeds, bool)
    mask[-1, -1] = it == 0
    jo = js.subgraph(seeds, seed_mask=mask, max_degree=max_degree)
    to = ts.subgraph(seeds, seed_mask=mask, max_degree=max_degree)
    for f in FIELDS + (('edge',) if kw.get('with_edge') else ()):
      _eq(getattr(jo, f), getattr(to, f), f'{name} {it} {f}')
    _eq(jo.metadata['mapping'], to.metadata['mapping'], 'mapping')
    _eq(jo.batch, to.batch, 'batch')
    assert to.num_sampled_nodes is None
  assert ts.state_dict() == js.state_dict()
  assert ts._global_max_degree() == js._global_max_degree()


def test_subgraph_induces_the_ring_edges():
  """``tests/test_distributed.py``'s analytic check on the port alone:
  the subgraph of {a, a+1, a+2} holds a->a+1, a->a+2, a+1->a+2 with
  their edge ids, and every seed maps to its node."""
  _, tg = graphs(ring(2))
  ts = gdist.DistNeighborSampler(tg, None, tmesh(2), seed=0, with_edge=True)
  seeds = np.array([[0, 1, 2, 10], [3, 4, 5, 11]], np.int32)
  out = ts.subgraph(seeds)
  node, row, col = out.node.numpy(), out.row.numpy(), out.col.numpy()
  em, edge = out.edge_mask.numpy(), out.edge.numpy()
  mapping = out.metadata['mapping'].numpy()
  for p, a in ((0, 0), (1, 3)):
    got = set()
    for r, c, e, m in zip(row[p], col[p], edge[p], em[p]):
      if m:
        u, v = int(node[p][r]), int(node[p][c])
        got.add((u, v))
        assert (v == (u + 1) % N and e == u) or \
            (v == (u + 2) % N and e == N + u)
    assert got == {(a, a + 1), (a, a + 2), (a + 1, a + 2)}
    for i, sd in enumerate(seeds[p]):
      assert node[p][mapping[p, i]] == sd


def test_typed_subgraph_is_refused_as_in_jax():
  from test_torch_dist_link import hetero_graphs, hetero_ring
  raw, pb, (et1, _) = hetero_ring(2)
  _, tg = hetero_graphs(raw, pb)
  ts = gdist.DistNeighborSampler(tg, {et1: [1]}, tmesh(2))
  with pytest.raises(NotImplementedError, match='reference parity'):
    ts.subgraph(np.zeros((2, 2), np.int32))


@pytest.mark.parametrize('kw', [
    dict(batch_size=5, seed=0, num_neighbors=None),
    dict(batch_size=3, seed=1, shuffle=True, drop_last=False,
         num_neighbors=[2], with_edge=True)])
def test_dist_subgraph_loader_equals_jax(kw):
  kw = dict(kw)
  fanouts = kw.pop('num_neighbors')
  parts, feats, node_pb, _ = fixture = ring(2)
  jg, tg = graphs(fixture)
  jds = glt.distributed.DistDataset(
      2, 0, jg, glt.distributed.DistFeature(2, feats, node_pb, jmesh(2)))
  tds = gdist.DistDataset(2, 0, tg,
                          gdist.DistFeature(2, feats, node_pb, tmesh(2)))
  jl = glt.distributed.DistSubGraphLoader(jds, fanouts, np.arange(N),
                                          mesh=jmesh(2), **kw)
  tl = gdist.DistSubGraphLoader(tds, fanouts, np.arange(N), mesh=tmesh(2),
                                **kw)
  assert len(tl) == len(jl) > 0
  for jb, tb in zip(jl, tl):
    for f in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x'):
      _eq(getattr(jb, f), getattr(tb, f), f)
    _eq(jb.metadata['mapping'], tb.metadata['mapping'], 'mapping')
    valid = tb.node >= 0
    assert torch.equal(tb.x[..., 0][valid], tb.node[valid].float())
