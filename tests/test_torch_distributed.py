"""The port's partitioned sampling path against the JAX package's
shard_map programs on the CPU.

Fixtures are ``tests/test_distributed.py``'s 40-node ring (node_pb = v
% P, features ``feat[v] = v``) at P = 2 and 4, a ring whose every node
lies on partition 0, and a random graph of a few hundred nodes split by
``RandomPartitioner``'s rule. Both packages see the same partitions,
seeds and PRNG seed; JAX runs its programs on the conftest's 8-device
CPU mesh, the port on a one-process ``ShardMesh`` (all P shards on the
CPU). Held exactly: the ``DistGraph`` arrays; ``DistFeature.get`` (hot
cache or none, ``bucket_frac`` 2.0 / None / a fallback-forcing 0.25,
bf16 on the wire, no dedup) and its counters; ``sample_from_nodes`` in
tree and merge modes, uniform and weighted, with edge ids, under a
``node_budget`` and under calibrated ``frontier_caps`` (the overflow
flag), with the fractional exchange falling back to full width; the
loader's batches, also from a partition directory that the port's
``RandomPartitioner`` wrote. Within atol 1e-5 / rtol 1e-4: the dense-tree
forward against the segment forward on a dist batch and against JAX's,
and one data-parallel step of the example (loss and parameters after
Adam) against JAX's ``pmean`` step. The host reads of the fractional
exchange's verdict are counted: one per exchange whose fractional
capacity is below the full width, none at ``bucket_frac=None``.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.typing import GraphPartitionData as JPart
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
from graphlearn_tpu_torch.typing import GraphPartitionData as TPart
from test_torch_cuda import STAT_KEYS, published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40
TOL = dict(rtol=1e-4, atol=1e-5)
FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask',
          'num_sampled_nodes', 'num_sampled_edges')


def jmesh(p):
  import jax
  from jax.sharding import Mesh
  return Mesh(np.array(jax.devices()[:p]), ('g',))


def tmesh(p):
  return gdist.ShardMesh(p, 'cpu')


def ring(num_parts, skew=False):
  """``(parts, feats, node_pb, edge_pb)`` of the ring v -> v+1, v+2;
  ``skew``: every node (and edge) on partition 0."""
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  eids = np.arange(2 * N)
  node_pb = (np.zeros(N) if skew else np.arange(N) % num_parts
             ).astype(np.int32)
  edge_pb = node_pb[rows]
  parts, feats = [], []
  for p in range(num_parts):
    m = edge_pb == p
    parts.append((np.stack([rows[m], cols[m]]), eids[m], None))
    ids = np.nonzero(node_pb == p)[0]
    feats.append((ids.astype(np.int64),
                  ids[:, None].astype(np.float32) * np.ones((1, 4),
                                                            np.float32)))
  return parts, feats, node_pb, edge_pb


def random_graph(num_parts, n=300, deg=6, seed=0):
  """A random graph with dyadic edge weights (exact float32 row CDFs)
  and 8-wide features, split by RandomPartitioner's rule (a seeded
  shuffle dealt in equal contiguous shares) with edges by source."""
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, n * deg)
  cols = rng.integers(0, n, n * deg)
  w = (rng.integers(1, 9, n * deg) / 4).astype(np.float32)
  perm = np.random.default_rng(seed + 1).permutation(n)
  share = (n + num_parts - 1) // num_parts
  node_pb = np.empty(n, np.int32)
  for p in range(num_parts):
    node_pb[perm[p * share:(p + 1) * share]] = p
  edge_pb = node_pb[rows]
  x = rng.standard_normal((n, 8)).astype(np.float32)
  eids = np.arange(n * deg)
  parts, feats = [], []
  for p in range(num_parts):
    m = edge_pb == p
    parts.append((np.stack([rows[m], cols[m]]), eids[m], w[m]))
    ids = np.nonzero(node_pb == p)[0]
    feats.append((ids.astype(np.int64), x[ids]))
  return parts, feats, node_pb, edge_pb


def graphs(fixture, weighted=False):
  """The same partitions as a JAX and a port ``DistGraph``."""
  parts, _, node_pb, edge_pb = fixture
  num_parts = len(parts)
  jp = [JPart(edge_index=ei, eids=e, weights=w if weighted else None)
        for ei, e, w in parts]
  tp = [TPart(edge_index=ei, eids=e, weights=w if weighted else None)
        for ei, e, w in parts]
  return (glt.distributed.DistGraph(num_parts, 0, jp, node_pb, edge_pb),
          gdist.DistGraph(num_parts, 0, tp, node_pb, edge_pb))


FIXTURES = {
    'ring2': lambda: ring(2), 'ring4': lambda: ring(4),
    'skew2': lambda: ring(2, skew=True),
    'rand2': lambda: random_graph(2), 'rand4': lambda: random_graph(4)}


def _np(v):
  return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_out_equal(jo, to, with_edge, what):
  for f in FIELDS + (('edge',) if with_edge else ()):
    a, b = np.asarray(getattr(jo, f)), _np(getattr(to, f))
    assert a.shape == b.shape, (what, f, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=f'{what} {f}')
  np.testing.assert_array_equal(np.asarray(jo.metadata['overflow']),
                                _np(to.metadata['overflow']),
                                err_msg=f'{what} overflow')
  np.testing.assert_array_equal(np.asarray(jo.metadata['seed_inverse']),
                                _np(to.metadata['seed_inverse']))


# ------------------------------------------------------------------ graph

@pytest.mark.parametrize('name', ['ring2', 'ring4', 'skew2', 'rand4'])
def test_dist_graph_arrays_equal_jax(name):
  jg, tg = graphs(FIXTURES[name](), weighted=name.startswith('rand'))
  for f in ('row_ids', 'indptr', 'indices', 'eids', 'node_pb'):
    a, b = getattr(jg, f), getattr(tg, f)
    assert a.dtype == b.dtype, f
    np.testing.assert_array_equal(a, b, err_msg=f)
  if name.startswith('rand'):
    np.testing.assert_array_equal(jg.weights, tg.weights)
    np.testing.assert_array_equal(jg.row_cumsum_stacked(),
                                  tg.row_cumsum_stacked())
  np.testing.assert_array_equal(jg.sorted_local_indices(),
                                tg.sorted_local_indices())
  dev = tg.device_arrays(tmesh(tg.num_partitions))
  np.testing.assert_array_equal(dev['eids'].numpy(), tg.eids)
  assert dev['row_ids'].dtype == torch.int32
  assert tg.get_node_partitions([0, 1]).tolist() == \
      jg.get_node_partitions([0, 1]).tolist()


def test_dist_hetero_graph_equals_jax():
  _, _, node_pb, _ = ring(2)
  et1, et2 = ('a', 'to', 'b'), ('b', 'to', 'a')
  rng = np.random.default_rng(3)
  raw = []
  for p in range(2):
    ei = np.stack([rng.integers(0, N, 30), rng.integers(0, N, 30)])
    raw.append({et1: (ei, np.arange(30) + 30 * p)})
    if p == 0:
      raw[p][et2] = (ei[::-1].copy(), np.arange(30))
  jparts = [{et: JPart(edge_index=e, eids=i) for et, (e, i) in r.items()}
            for r in raw]
  tparts = [{et: TPart(edge_index=e, eids=i) for et, (e, i) in r.items()}
            for r in raw]
  pbs = {'a': node_pb, 'b': node_pb}
  jg = glt.distributed.DistHeteroGraph(2, 0, jparts, pbs)
  tg = gdist.DistHeteroGraph(2, 0, tparts, pbs)
  assert tg.etypes == jg.etypes and tg.ntypes == jg.ntypes
  assert tg.is_hetero and tg.num_nodes('a') == N
  for et in jg.etypes:
    for f in ('row_ids', 'indptr', 'indices', 'eids'):
      np.testing.assert_array_equal(getattr(jg.sub[et], f),
                                    getattr(tg.sub[et], f))
  dev = tg.device_arrays(tmesh(2))
  assert set(dev['#pb']) == {'a', 'b'}
  # the typed engine over these graphs samples JAX's batch
  seeds = ('a', np.arange(8, dtype=np.int32).reshape(2, 4))
  jo = glt.distributed.DistNeighborSampler(jg, [2], jmesh(2),
                                           seed=1).sample_from_nodes(seeds)
  to = gdist.DistNeighborSampler(tg, [2], tmesh(2),
                                 seed=1).sample_from_nodes(seeds)
  for f in FIELDS:
    a, b = getattr(jo, f), getattr(to, f)
    assert set(a) == set(b), f
    for k in a:
      np.testing.assert_array_equal(np.asarray(a[k]), _np(b[k]))


# ---------------------------------------------------------------- feature

FEATURE_CASES = [
    ('ring2', {}), ('ring4', dict(bucket_frac=None)),
    ('ring4', dict(bucket_frac=0.25)),
    ('rand4', dict(cache_rows=60)),
    ('rand4', dict(cache_rows=60, bucket_frac=None)),
    ('rand4', dict(split_ratio=0.1, hotness='deg', wire_dtype='bfloat16')),
    ('rand2', dict(dedup=False)),
]


@pytest.mark.parametrize('name,kw', FEATURE_CASES)
def test_dist_feature_get_equals_jax(name, kw):
  import jax.numpy as jnp
  parts, feats, node_pb, _ = FIXTURES[name]()
  p = len(parts)
  n = node_pb.shape[0]
  kw = dict(kw)
  if kw.get('hotness') == 'deg':
    kw['hotness'] = np.bincount(np.concatenate([e[1] for e, _, _ in parts]),
                                minlength=n)
  jkw = dict(kw)
  if 'wire_dtype' in kw:
    jkw['wire_dtype'] = jnp.bfloat16
  jf = glt.distributed.DistFeature(p, feats, node_pb, jmesh(p), **jkw)
  tf = gdist.DistFeature(p, feats, node_pb, tmesh(p), **kw)
  gdist.reset_verdict_syncs()
  rng = np.random.default_rng(4)
  for b in (12, 24):
    ids = rng.integers(-1, n, (p, b)).astype(np.int32)
    ids[:, 1] = ids[:, 0]                      # a repeated request
    want = np.asarray(jf.get(ids))
    got = tf.get(torch.as_tensor(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(tf.cpu_get(ids[0]).numpy(),
                                  np.asarray(jf.cpu_get(ids[0])))
  assert tf.stats() == jf.stats()
  frac = kw.get('bucket_frac', 2.0)
  hit = tf.cache_rows / n
  want_syncs = sum(gdist.miss_capacity(b, p, frac, hit) < b
                   for b in (12, 24))
  assert gdist.verdict_syncs() == want_syncs
  tf.reset_stats()
  assert tf.stats()['lookups'] == 0
  assert gdist.feature_exchange_mb(24, p, 8, frac) == \
      glt.distributed.dist_feature.feature_exchange_mb(24, p, 8, frac)


# ---------------------------------------------------------------- sampler

SAMPLER_CASES = [
    ('ring2', dict(dedup='tree', with_edge=True)),
    ('ring2', dict(dedup='sort', bucket_frac=None)),
    ('ring4', dict(dedup='tree', bucket_frac=None, with_edge=True)),
    ('ring4', dict(dedup='merge', with_edge=True)),
    ('skew2', dict(dedup='merge', with_edge=True)),
    ('rand4', dict(dedup='tree', with_edge=True)),
    ('rand4', dict(dedup='merge')),
    ('rand4', dict(dedup='merge', bucket_frac=0.25, with_edge=True)),
    ('rand2', dict(dedup='merge', with_weight=True, with_edge=True)),
    ('rand4', dict(dedup='tree', with_weight=True, bucket_frac=None)),
    ('ring2', dict(dedup='tree', node_budget=6)),
    ('ring2', dict(dedup='merge', frontier_caps=[8, 8])),
    ('ring2', dict(dedup='merge', frontier_caps=[8, 2])),
]


def _seeds(name, p, b, it):
  n = N if name.startswith(('ring', 'skew')) else 300
  if name == 'ring2' and b == 4:
    return np.array([[0, 8, 16, 24], [1, 9, 17, 25]], np.int32) + it
  return np.random.default_rng(10 + it).permutation(n)[:p * b].reshape(
      p, b).astype(np.int32)


@pytest.mark.parametrize('name,kw', SAMPLER_CASES)
def test_sample_from_nodes_equals_jax(name, kw):
  fixture = FIXTURES[name]()
  p = len(fixture[0])
  jg, tg = graphs(fixture, weighted=kw.get('with_weight', False))
  fanouts = [2, 2] if name.startswith(('ring', 'skew')) else [3, 2]
  js = glt.distributed.DistNeighborSampler(jg, fanouts, jmesh(p), seed=2,
                                           **kw)
  ts = gdist.DistNeighborSampler(tg, fanouts, tmesh(p), seed=2, **kw)
  assert ts.dedup == js.dedup and ts.clamped_exact == js.clamped_exact
  b = 4 if name.startswith(('ring', 'skew')) else 16
  assert ts.hop_caps(b) == js.hop_caps(b)
  frac = kw.get('bucket_frac', 2.0)
  caps = ts.hop_caps(b)
  # one verdict read per hop whose fractional capacity is below the
  # frontier width (the labels and features are not read here)
  per_batch = sum(gtt.ops.exchange_capacity(caps[i], p, frac) < caps[i]
                  for i in range(len(fanouts)))
  gdist.reset_verdict_syncs()
  for it in range(2):
    seeds = _seeds(name, p, b, it)
    mask = np.ones_like(seeds, bool)
    mask[-1, -1] = it == 0                     # a padded seed in batch 1
    jo = js.sample_from_nodes(seeds, seed_mask=mask)
    to = ts.sample_from_nodes(seeds, seed_mask=mask)
    assert_out_equal(jo, to, kw.get('with_edge', False), f'{name} {it}')
  assert gdist.verdict_syncs() == 2 * per_batch
  if kw.get('frontier_caps') == [8, 2]:
    assert _np(to.metadata['overflow']).all()
  elif 'frontier_caps' in kw:
    assert not _np(to.metadata['overflow']).any()
  assert ts.state_dict() == js.state_dict()


def test_fractional_exchange_falls_back_with_the_same_draws():
  """A batch whose buckets overflow the fractional capacity: the seeds
  of every shard are owned by partition 0, so 16 requests meet an
  8-wide bucket and every hop falls back to the full width. The draws
  (a function of the bucket capacity) still equal JAX's, which takes the
  same branch under lax.cond; one verdict read per hop."""
  fixture = random_graph(4)
  jg, tg = graphs(fixture)
  node_pb = fixture[2]
  own0 = np.nonzero(node_pb == 0)[0]
  seeds = np.stack([own0[i * 16:(i + 1) * 16] for i in range(4)]).astype(
      np.int32)
  assert gtt.ops.exchange_capacity(16, 4, 2.0) == 8
  for dedup in ('tree', 'merge'):
    js = glt.distributed.DistNeighborSampler(jg, [3, 2], jmesh(4), seed=5,
                                             dedup=dedup, with_edge=True)
    ts = gdist.DistNeighborSampler(tg, [3, 2], tmesh(4), seed=5,
                                   dedup=dedup, with_edge=True)
    gdist.reset_verdict_syncs()
    assert_out_equal(js.sample_from_nodes(seeds),
                     ts.sample_from_nodes(seeds), True, dedup)
    assert gdist.verdict_syncs() == 2
  # the buckets would overflow: route_slots reports it, and the
  # full-width route is loss-free
  dest = torch.as_tensor(node_pb[seeds[1]])
  _, ok, over = gtt.ops.route_slots(dest, torch.ones(16, dtype=torch.bool),
                                    8, with_overflow=True)
  assert int(over) == 8 and int(ok.sum()) == 8


def test_explicit_keys_replay_and_state_round_trip():
  fixture = random_graph(4)
  _, tg = graphs(fixture)
  ts = gdist.DistNeighborSampler(tg, [3, 2], tmesh(4), seed=9, dedup='merge')
  seeds = _seeds('rand4', 4, 16, 0)
  keys = ts._next_keys()
  a = ts.sample_from_nodes(seeds, keys=keys)
  b = ts.sample_from_nodes(seeds, keys=keys)
  for f in FIELDS:
    assert torch.equal(getattr(a, f), getattr(b, f))
  state = ts.state_dict()
  c = ts.sample_from_nodes(seeds)
  ts2 = gdist.DistNeighborSampler(tg, [3, 2], tmesh(4), seed=0,
                                  dedup='merge')
  ts2.load_state_dict(state)
  d = ts2.sample_from_nodes(seeds)
  assert torch.equal(c.node, d.node)
  with pytest.raises(ValueError, match='different sampler type'):
    ts2.load_state_dict({'call_count': 1})
  clone = ts.uncapped_clone()
  assert clone.frontier_caps is None and clone._key is ts._key


def test_sampler_refusals_name_the_next_slice():
  """What the distributed sampler still refuses, as JAX does: a typed
  subgraph (the reference has none), dict-form caps on a homogeneous
  graph, 'auto' caps, and caps on the positional tree engine."""
  from test_torch_dist_link import hetero_graphs, hetero_ring
  raw, pb, (et1, _) = hetero_ring(2)
  _, thg = hetero_graphs(raw, pb)
  with pytest.raises(NotImplementedError, match='reference parity'):
    gdist.DistNeighborSampler(thg, {et1: [1]}, tmesh(2)).subgraph(
        np.zeros((2, 4), np.int32))
  _, tg = graphs(ring(2))
  with pytest.raises(ValueError, match='hetero-only'):
    gdist.DistNeighborSampler(tg, [2], tmesh(2), frontier_caps={et1: [4]})
  with pytest.raises(ValueError, match='explicit caps'):
    gdist.DistNeighborSampler(tg, [2], tmesh(2), frontier_caps='auto')
  with pytest.raises(ValueError, match='frontier_caps requires'):
    gdist.DistNeighborSampler(tg, [2], tmesh(2), dedup='tree',
                              frontier_caps=[4])


# ----------------------------------------------------------------- loader

def _loader_pair(p, fixture, labels, **kw):
  parts, feats, node_pb, edge_pb = fixture
  jg, tg = graphs(fixture)
  jf = glt.distributed.DistFeature(p, feats, node_pb, jmesh(p))
  tf = gdist.DistFeature(p, feats, node_pb, tmesh(p))
  jds = glt.distributed.DistDataset(p, 0, jg, jf, node_labels=labels)
  tds = gdist.DistDataset(p, 0, tg, tf, node_labels=labels)
  jl = glt.distributed.DistNeighborLoader(jds, [2, 2], np.arange(N),
                                          mesh=jmesh(p), **kw)
  tl = gdist.DistNeighborLoader(tds, [2, 2], np.arange(N), mesh=tmesh(p),
                                **kw)
  return jl, tl


def assert_batches_equal(jl, tl, fields=('node', 'num_nodes', 'edge_index',
                                         'edge_mask', 'x', 'y', 'batch',
                                         'num_sampled_nodes',
                                         'num_sampled_edges')):
  steps = 0
  for jb, tb in zip(jl, tl):
    steps += 1
    for f in fields:
      a, b = np.asarray(getattr(jb, f)), _np(getattr(tb, f))
      assert a.shape == b.shape, (f, a.shape, b.shape)
      np.testing.assert_array_equal(a, b, err_msg=f)
  assert steps == len(jl) == len(tl) > 0
  return steps


@pytest.mark.parametrize('kw', [
    dict(batch_size=4, shuffle=True, seed=0),
    dict(batch_size=3, shuffle=True, seed=1, drop_last=False,
         dedup='tree', seed_labels_only=True)])
def test_dist_loader_end_to_end_equals_jax(kw):
  labels = np.arange(N) % 4
  jl, tl = _loader_pair(2, ring(2), labels, **kw)
  steps = assert_batches_equal(jl, tl)
  if not kw.get('drop_last', True):
    assert steps == -(-N // (2 * kw['batch_size']))
  # features fetched across shards match the global ids (the JAX test)
  for batch in tl:
    valid = batch.node >= 0
    assert torch.equal(batch.x[..., 0][valid], batch.node[valid].float())
  state = tl.state_dict()
  want = [b.node for b in tl]
  jl2, tl2 = _loader_pair(2, ring(2), labels, **kw)
  tl2.load_state_dict(state)
  got = [b.node for b in tl2]
  assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_dist_dataset_load_from_the_ports_partition_dir(tmp_path):
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  feat = np.arange(N, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)
  gtt.partition.RandomPartitioner(
      str(tmp_path), 2, N, np.stack([rows, cols]), node_feat=feat,
      seed=0).partition()
  labels = np.arange(N) % 3
  for kw in ({}, dict(cache_rows=8, bucket_frac=None)):
    jds = glt.distributed.DistDataset().load(
        str(tmp_path), mesh=jmesh(2), node_labels=labels, **kw)
    tds = gdist.DistDataset().load(str(tmp_path), mesh=tmesh(2),
                                   node_labels=labels, **kw)
    assert tds.num_partitions == 2
    np.testing.assert_array_equal(tds.node_pb, jds.node_pb)
    np.testing.assert_array_equal(tds.node_feat_pb, jds.node_feat_pb)
    assert tds.node_features.cache_rows == jds.node_features.cache_rows
    assert list(tds.feature_stores()) == [tds.node_features]
    jl = glt.distributed.DistNeighborLoader(jds, [2], np.arange(N),
                                            batch_size=4, seed=0,
                                            mesh=jmesh(2))
    tl = gdist.DistNeighborLoader(tds, [2], np.arange(N), batch_size=4,
                                  seed=0, mesh=tmesh(2))
    jbefore = glt.utils.trace.counters('dist_feature')
    with published({'node': tds.node_features}) as got:
      assert_batches_equal(jl, tl)
    jafter = glt.utils.trace.counters('dist_feature')
    # both loaders drain their counters into the registry at the epoch's
    # end (publish_stats): the port's published what JAX's did
    st = got['node']
    assert st['lookups'] == st['hits'] + st['misses'] > 0
    assert st == {k: jafter.get(f'dist_feature.{k}', 0) -
                  jbefore.get(f'dist_feature.{k}', 0) for k in STAT_KEYS}
    assert tds.node_features.stats()['lookups'] == 0
  # feature_spill_dir: the node store spills to disk tiers and serves
  # the same rows (TieredDistFeature)
  spilled = gdist.DistDataset().load(str(tmp_path), mesh=tmesh(2),
                                     node_labels=labels,
                                     feature_spill_dir=str(tmp_path / 'sp'))
  assert isinstance(spilled.node_features, gtt.storage.TieredDistFeature)
  assert (tmp_path / 'sp' / 'node').is_dir()
  ids = torch.as_tensor(np.arange(16, dtype=np.int32).reshape(2, 8))
  assert torch.equal(spilled.node_features.get(ids),
                     tds.node_features.get(ids))


def test_dist_loader_overflow_policies():
  """Calibrated caps too small for every batch: the default policy
  raises at the epoch's end; 'recompute' replays each batch at full
  capacities with the same keys, equal to an uncapped loader's."""
  labels = np.arange(N) % 4
  spread = (np.arange(N) * 13) % N
  parts, feats, node_pb, edge_pb = ring(2)
  _, tg = graphs(ring(2))
  tds = gdist.DistDataset(2, 0, tg, gdist.DistFeature(2, feats, node_pb,
                                                      tmesh(2)),
                          node_labels=labels)

  def loader(**kw):
    return gdist.DistNeighborLoader(tds, [2, 2], spread, batch_size=4,
                                    seed=0, mesh=tmesh(2), dedup='merge',
                                    **kw)
  with pytest.raises(RuntimeError, match='frontier_caps overflowed'):
    for _ in loader(frontier_caps=[8, 2]):
      pass
  fix = loader(frontier_caps=[8, 2], overflow_policy='recompute')
  ref = loader(overflow_policy='off')
  for got, want in zip(fix, ref):
    for f in ('node', 'edge_index', 'edge_mask', 'x', 'y'):
      assert torch.equal(getattr(got, f), getattr(want, f)), f
  assert fix.overflow_recomputes == len(ref) > 0


# ------------------------------------------------------------------ model

def test_dense_tree_forward_equals_segment_on_a_dist_batch():
  import jax
  from graphlearn_tpu.models import train as jtrain
  from graphlearn_tpu_torch.models import convert
  parts, feats, node_pb, edge_pb = ring(2)
  jl, tl = _loader_pair(2, ring(2), None, batch_size=4, seed=0,
                        dedup='tree')
  jb, tb = next(iter(jl)), next(iter(tl))
  no, eo = gtt.models.tree_hop_offsets(4, [2, 2])
  assert (no, eo) == jtrain.tree_hop_offsets(4, [2, 2])
  kw = dict(num_layers=2, hop_node_offsets=no, hop_edge_offsets=eo,
            device='cpu')
  seg = gtt.models.GraphSAGE(4, 8, 3, **kw)
  dense = gtt.models.GraphSAGE(4, 8, 3, tree_dense=True, fanouts=(2, 2),
                               **kw)
  jdense = glt.models.GraphSAGE(hidden_dim=8, out_dim=3, num_layers=2,
                                hop_node_offsets=no, hop_edge_offsets=eo,
                                tree_dense=True, fanouts=(2, 2))
  x = np.asarray(jb.x)
  ei = np.asarray(jb.edge_index)
  em = np.asarray(jb.edge_mask)
  params = jdense.init(jax.random.PRNGKey(0), x[0], ei[0], em[0])
  sd = convert.params_from_flax(jax.tree.map(np.asarray, params))
  seg.load_state_dict(sd)
  dense.load_state_dict(sd)
  with torch.no_grad():
    for p in range(2):
      nseed = int(tb.num_sampled_nodes[p, 0])
      o_seg = seg(tb.x[p], tb.edge_index[p], tb.edge_mask[p])[:nseed]
      o_dense = dense(tb.x[p], tb.edge_index[p], tb.edge_mask[p])[:nseed]
      torch.testing.assert_close(o_seg, o_dense, rtol=2e-5, atol=2e-5)
      want = np.asarray(jdense.apply(params, x[p], ei[p], em[p]))[:nseed]
      np.testing.assert_allclose(o_dense.numpy(), want, **TOL)


def _jax_dp_step(jm, tx, ncls):
  """The JAX example's data-parallel step (its dp_step under shard_map):
  per-shard grads, pmean over 'g', one optax step."""
  import jax
  import jax.numpy as jnp
  import optax
  from jax.sharding import PartitionSpec as PS

  from graphlearn_tpu.utils.compat import shard_map

  def loss_fn(params, x, ei, em, y, nseed):
    logits = jm.apply(params, x, ei, em)
    n = min(logits.shape[0], y.shape[0])
    logits, y = logits[:n], y[:n]
    seed_mask = jnp.arange(n) < nseed
    ce = optax.softmax_cross_entropy(logits, jax.nn.one_hot(y, ncls))
    loss = jnp.where(seed_mask, ce, 0.0).sum() / jnp.maximum(
        seed_mask.sum(), 1)
    acc = (((logits.argmax(-1) == y) & seed_mask).sum() /
           jnp.maximum(seed_mask.sum(), 1))
    return loss, acc

  def dp_step(params, opt_state, x, ei, em, y, nseed):
    (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, x[0], ei[0], em[0], y[0], nseed[0])
    grads = jax.lax.pmean(grads, 'g')
    loss = jax.lax.pmean(loss, 'g')
    acc = jax.lax.pmean(acc, 'g')
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, acc

  return jax.jit(shard_map(
      dp_step, mesh=jmesh(4),
      in_specs=(PS(), PS(), PS('g'), PS('g'), PS('g'), PS('g'), PS('g')),
      out_specs=(PS(), PS(), PS(), PS()), check_replication=False))


def test_example_dp_step_equals_jax_pmean_step():
  import jax
  import optax
  from graphlearn_tpu.models import train as jtrain
  from graphlearn_tpu_torch.models import convert
  ncls, p, b, fan = ex.NUM_CLASSES, 4, 8, [3, 2]
  ei, x, labels = ex.make_graph(400, 6, ncls, np.random.default_rng(0),
                                feat_dim=8)
  node_pb = (np.arange(400) % p).astype(np.int32)
  tparts, tfeats = ex.partition_in_memory(ei, x, node_pb, p)
  jparts = [JPart(edge_index=t.edge_index, eids=t.eids) for t in tparts]
  jds = glt.distributed.DistDataset(
      p, 0, glt.distributed.DistGraph(p, 0, jparts, node_pb),
      glt.distributed.DistFeature(p, tfeats, node_pb, jmesh(p)),
      node_labels=labels.astype(np.int64))
  tds = ex.build_dataset(ei, x, labels, node_pb, tmesh(p))
  kw = dict(batch_size=b, shuffle=True, drop_last=True, seed=0,
            dedup='tree')
  jb = next(iter(glt.distributed.DistNeighborLoader(
      jds, fan, np.arange(400), mesh=jmesh(p), **kw)))
  tb = next(iter(gdist.DistNeighborLoader(tds, fan, np.arange(400),
                                          mesh=tmesh(p), **kw)))
  np.testing.assert_array_equal(np.asarray(jb.x), tb.x.numpy())
  np.testing.assert_array_equal(np.asarray(jb.y), tb.y.numpy())
  no, eo = jtrain.tree_hop_offsets(b, fan)
  jm = glt.models.GraphSAGE(hidden_dim=16, out_dim=ncls, num_layers=2,
                            hop_node_offsets=no, hop_edge_offsets=eo,
                            tree_dense=True, fanouts=tuple(fan))
  params = jm.init(jax.random.PRNGKey(0), np.asarray(jb.x)[0],
                   np.asarray(jb.edge_index)[0], np.asarray(jb.edge_mask)[0])
  tx = optax.adam(3e-3)
  step = _jax_dp_step(jm, tx, ncls)
  new_params, _, jloss, jacc = step(
      params, tx.init(params), jb.x, jb.edge_index, jb.edge_mask, jb.y,
      jb.num_sampled_nodes[:, 0])
  tm = ex.make_model(8, 16, ncls, fan, b, 'cpu')
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  state = gtt.models.create_train_state(tm, lr=3e-3)
  loss, acc = ex.dp_step(tm, state.optimizer, tb, tmesh(p))
  np.testing.assert_allclose(float(loss), float(jloss), **TOL)
  np.testing.assert_allclose(float(acc), float(jacc), **TOL)
  want = convert.params_from_flax(jax.tree.map(np.asarray, new_params))
  got = tm.state_dict()
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                               err_msg=name, **TOL)


def test_example_main_runs_on_the_cpu(capsys):
  ex.main(['--device', 'cpu', '--num-nodes', '1000', '--epochs', '1',
           '--batch-size', '32', '--hidden', '16', '--num-partitions', '4'])
  import json
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['mesh_size'] == 4 and np.isfinite(line['final_loss'])


def test_example_defaults_to_one_partition_per_device(capsys):
  """JAX's rule: one partition per device; a named device is one."""
  ex.main(['--device', 'cpu', '--num-nodes', '400', '--epochs', '1',
           '--batch-size', '32', '--hidden', '8'])
  import json
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['mesh_size'] == 1 and line['ranks'] == 1
  assert np.isfinite(line['final_loss'])
