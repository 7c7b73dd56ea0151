"""The port's multiprocess loaders against JAX's in-process sampler, on
the CPU.

Mirrors ``tests/test_server_client.py``'s mp-loader tests (homogeneous,
typed, link, typed link: ``MpDistNeighborLoader`` /
``MpDistLinkNeighborLoader`` over ``DistMpSamplingProducer`` and the
shared-memory ring). Arrival order across workers is not deterministic,
so each batch is keyed by its worker and its seed block (the seeds it
carries in 'batch', or its positive pairs for a link batch) and held
exactly — ids, masks, features, labels and metadata — against JAX's
in-process ``NeighborSampler`` at that worker's seed
(``seed * 1000003 + rank``) and call index, over the same static split
and epoch order (``np.random.default_rng(seed)``).
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.channel import live_channel_count

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40


@pytest.fixture(autouse=True)
def no_ring_left():
  base = live_channel_count()
  yield
  assert live_channel_count() == base


def ring_edges(n=N):
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  return np.stack([rows, cols])


def random_edges(n=N, deg=6, seed=4):
  """Degrees above the fanouts, so every draw depends on its key."""
  rng = np.random.default_rng(seed)
  return np.stack([rng.integers(0, n, n * deg), rng.integers(0, n, n * deg)])


def datasets(ei=None, n=N, feat_dim=4):
  ei = random_edges(n) if ei is None else ei
  rng = np.random.default_rng(9)
  feat = rng.standard_normal((n, feat_dim)).astype(np.float32)
  labels = np.arange(n) % 3
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=n)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(feat)
  ds.init_node_labels(labels)
  return jds, ds, feat, labels


def epoch_orders(seed, splits, shuffle, epochs):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(epochs):
    out.append([rng.permutation(s.shape[0]) if shuffle
                else np.arange(s.shape[0]) for s in splits])
  return out


def key_node_batch(seed_ids, seeds, splits, orders, bs):
  """(worker, batch index in its epoch) of a batch by its first seed."""
  for w, s in enumerate(splits):
    pos = np.nonzero(seeds[s][orders[w]] == seed_ids[0])[0]
    if pos.size:
      return w, int(pos[0]) // bs
  raise AssertionError(f'seed {seed_ids[0]} in no worker share')


def assert_homo_batch(b, jout, feat, labels):
  node = np.asarray(jout.node)
  np.testing.assert_array_equal(b.node.numpy(), node)
  assert b.num_nodes == int(jout.num_nodes)
  np.testing.assert_array_equal(b.edge_index.numpy(),
                                np.stack([jout.row, jout.col]))
  np.testing.assert_array_equal(b.edge_mask.numpy(),
                                np.asarray(jout.edge_mask))
  np.testing.assert_array_equal(b.x.numpy(), feat[np.maximum(node, 0)])
  np.testing.assert_array_equal(
      b.y.numpy(), labels[np.clip(node, 0, labels.shape[0] - 1)])
  np.testing.assert_array_equal(b.batch.numpy(), np.asarray(jout.batch))
  assert b.batch_size == jout.batch_size
  np.testing.assert_array_equal(
      np.asarray(b.num_sampled_nodes),
      np.asarray([np.asarray(v) for v in jout.num_sampled_nodes]))
  for k in ('seed_inverse', 'overflow'):
    np.testing.assert_array_equal(np.asarray(b.metadata[k]).reshape(-1),
                                  np.asarray(jout.metadata[k]).reshape(-1))


def test_mp_dist_neighbor_loader_matches_jax():
  """Two workers, shuffled, two epochs: every batch equals JAX's sampler
  at its worker's seed and call index; every seed is seen once an epoch;
  the workers' metric snapshots (with their launch counts) arrive."""
  jds, ds, feat, labels = datasets()
  seeds, bs, W, seed = np.arange(N), 4, 2, 0
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, [3, 2], seeds, batch_size=bs, shuffle=True, num_workers=W,
      seed=seed)
  splits = np.array_split(np.arange(N), W)
  orders = epoch_orders(seed, splits, True, 2)
  per_worker = [-(-s.shape[0] // bs) for s in splits]
  try:
    assert len(loader) == sum(per_worker) == 10
    for epoch in range(2):
      seen, got = [], {}
      for b in loader:
        ids = b.batch.numpy()[:b.batch_size]
        seen.extend(ids.tolist())
        got[key_node_batch(ids, seeds, splits, orders[epoch], bs)] = b
      assert sorted(seen) == list(range(N))
      assert len(got) == len(loader)
      for (w, j), b in got.items():
        js = glt.sampler.NeighborSampler(jds.graph, [3, 2],
                                         seed=seed * 1000003 + w)
        js._call_count = epoch * per_worker[w] + j
        blk = seeds[splits[w]][orders[epoch][w]][j * bs:(j + 1) * bs]
        jout = js.sample_from_nodes(glt.sampler.NodeSamplerInput(blk),
                                    batch_cap=bs)
        assert_homo_batch(b, jout, feat, labels)
    snap = None
    for _ in range(100):
      snap = loader.worker_metrics()
      if snap is not None and snap['workers'] == [0, 1]:
        break
      import time
      time.sleep(0.05)
    assert snap['workers'] == [0, 1]
    assert snap['counters']['producer.batches'] == 2 * len(loader)
    # a CPU worker runs the plain versions: no kernel launched
    assert set(snap['launches']) == set(gtt.ops.launch_counts())
    assert sum(snap['launches'].values()) == 0
  finally:
    loader.shutdown()
  assert all(not p.is_alive() for p in loader.producer._procs)


UB, BU = ('user', 'buys', 'item'), ('item', 'rev_buys', 'user')
NU, NI = 30, 20


def typed_datasets():
  rng = np.random.default_rng(6)
  ub = np.stack([rng.integers(0, NU, 150), rng.integers(0, NI, 150)])
  feats = {'user': rng.standard_normal((NU, 3)).astype(np.float32),
           'item': rng.standard_normal((NI, 3)).astype(np.float32)}
  edges = {UB: ub, BU: ub[::-1].copy()}
  nn = {UB: NU, BU: NI}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU', num_nodes=nn)
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph(edges, num_nodes=nn)
  ds.init_node_features(feats)
  ds.init_node_labels({'user': np.arange(NU) % 2})
  return jds, ds, feats, ub


def jax_worker_batches(jds, fan, seed, w, inputs):
  """JAX's sampler of worker ``w`` over its blocks in order (a typed
  batch takes one key per (hop, edge type) item of the stream)."""
  js = glt.sampler.NeighborSampler(jds.graph, fan, seed=seed * 1000003 + w)
  return [js.sample_from_nodes(inp, batch_cap=cap) if cap else
          js.sample_from_edges(inp) for inp, cap in inputs]


def assert_typed_batch(b, jout, feats, ylab=None):
  for t, v in jout.node.items():
    np.testing.assert_array_equal(b.node[t].numpy(), np.asarray(v))
    assert b.num_nodes[t] == int(jout.num_nodes[t])
    np.testing.assert_array_equal(
        b.x[t].numpy(), feats[t][np.maximum(np.asarray(v), 0)])
  assert set(b.edge_index) == set(jout.row)
  for et in jout.row:
    np.testing.assert_array_equal(
        b.edge_index[et].numpy(), np.stack([jout.row[et], jout.col[et]]))
    np.testing.assert_array_equal(b.edge_mask[et].numpy(),
                                  np.asarray(jout.edge_mask[et]))
  if ylab is not None:
    for t, lab in ylab.items():
      node = np.asarray(jout.node[t])
      np.testing.assert_array_equal(
          b.y[t].numpy(), lab[np.clip(node, 0, lab.shape[0] - 1)])


def test_mp_dist_hetero_loader_matches_jax():
  """Typed seeds ('user', ids) through two workers: typed batches equal
  JAX's typed sampler at the worker seed, features and labels by type."""
  jds, ds, feats, _ = typed_datasets()
  fan = {UB: [3, 2], BU: [2, 2]}
  seeds, bs, W, seed = np.arange(12), 2, 2, 0
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, fan, ('user', seeds), batch_size=bs, shuffle=True,
      num_workers=W, seed=seed)
  splits = np.array_split(np.arange(12), W)
  orders = epoch_orders(seed, splits, True, 1)[0]
  try:
    seen, got = [], {}
    for b in loader:
      assert set(b.node) == {'user', 'item'}
      ids = b.batch['user'].numpy()[:b.batch_size]
      seen.extend(ids.tolist())
      got[key_node_batch(ids, seeds, splits, orders, bs)] = b
    assert sorted(seen) == list(range(12)) and len(got) == len(loader)
    assert b.metadata.get('input_type') == 'user'
    for w in range(W):
      blks = seeds[splits[w]][orders[w]]
      want = jax_worker_batches(jds, fan, seed, w, [
          (glt.sampler.NodeSamplerInput(blks[i:i + bs], 'user'), bs)
          for i in range(0, blks.shape[0], bs)])
      for j, jout in enumerate(want):
        assert_typed_batch(got[(w, j)], jout, feats,
                           {'user': np.arange(NU) % 2})
  finally:
    loader.shutdown()


def _link_key(b, splits, rows, cols, bs):
  """(worker, batch index) of a link batch by its first positive pair."""
  eli = np.asarray(b.metadata['edge_label_index'])
  u, v = int(b.node[eli[0, 0]]), int(b.node[eli[1, 0]])
  for w, s in enumerate(splits):
    pos = np.nonzero((rows[s] == u) & (cols[s] == v))[0]
    if pos.size:
      return w, int(pos[0]) // bs
  raise AssertionError((u, v))


def test_mp_dist_link_loader_matches_jax():
  """Link sampling with binary negatives through two workers; the short
  last block is padded cyclically, as in JAX."""
  from graphlearn_tpu.sampler import EdgeSamplerInput as JESI
  from graphlearn_tpu.sampler import NegativeSampling as JNS
  jds, ds, feat, labels = datasets()
  rows, cols = np.arange(N), (np.arange(N) + 1) % N
  bs, W, seed = 6, 2, 3
  loader = gtt.distributed.MpDistLinkNeighborLoader(
      ds, [2], np.stack([rows, cols]),
      neg_sampling=gtt.sampler.NegativeSampling('binary', 1),
      batch_size=bs, num_workers=W, seed=seed)
  splits = np.array_split(np.arange(N), W)
  try:
    got = {}
    for b in loader:
      got[_link_key(b, splits, rows, cols, bs)] = b
    assert len(got) == len(loader) == 2 * 4
    for (w, j), b in got.items():
      js = glt.sampler.NeighborSampler(jds.graph, [2],
                                       seed=seed * 1000003 + w)
      js._call_count = j
      idx = splits[w][j * bs:(j + 1) * bs]
      if idx.shape[0] < bs:
        idx = np.resize(idx, bs)
      jout = js.sample_from_edges(JESI(rows[idx], cols[idx],
                                       neg_sampling=JNS('binary', 1)))
      np.testing.assert_array_equal(b.node.numpy(), np.asarray(jout.node))
      np.testing.assert_array_equal(b.edge_index.numpy(),
                                    np.stack([jout.row, jout.col]))
      np.testing.assert_array_equal(b.edge_mask.numpy(),
                                    np.asarray(jout.edge_mask))
      np.testing.assert_array_equal(
          b.x.numpy(), feat[np.maximum(np.asarray(jout.node), 0)])
      for k in ('edge_label_index', 'edge_label'):
        np.testing.assert_array_equal(np.asarray(b.metadata[k]),
                                      np.asarray(jout.metadata[k]))
      label = np.asarray(b.metadata['edge_label'])
      assert (label == 1).sum() > 0 and (label == 0).sum() > 0
  finally:
    loader.shutdown()


def test_mp_dist_hetero_link_loader_matches_jax():
  """Typed seed edges ((src, rel, dst), [2, E]) through one worker: the
  typed link engine's batches equal JAX's, positives decode to real
  typed edges."""
  from graphlearn_tpu.sampler import EdgeSamplerInput as JESI
  from graphlearn_tpu.sampler import NegativeSampling as JNS
  jds, ds, feats, ub = typed_datasets()
  fan = {UB: [3], BU: [2]}
  bs, seed, E = 4, 1, 10
  loader = gtt.distributed.MpDistLinkNeighborLoader(
      ds, fan, (UB, ub[:, :E]),
      neg_sampling=gtt.sampler.NegativeSampling('binary', 1),
      batch_size=bs, num_workers=1, seed=seed)
  pos = {(int(r), int(c)) for r, c in zip(ub[0], ub[1])}
  try:
    got = list(loader)    # one worker's batches are in order
    assert len(got) == len(loader) == 3
    idx = [np.resize(np.arange(E)[i:i + bs], bs) for i in range(0, E, bs)]
    want = jax_worker_batches(jds, fan, seed, 0, [
        (JESI(ub[0][i], ub[1][i], input_type=UB,
              neg_sampling=JNS('binary', 1)), None) for i in idx])
    for b, jout in zip(got, want):
      assert b.metadata['input_type'] == 'user__buys__item'
      assert_typed_batch(b, jout, feats)
      for k in ('edge_label_index', 'edge_label'):
        np.testing.assert_array_equal(np.asarray(b.metadata[k]),
                                      np.asarray(jout.metadata[k]))
      eli = np.asarray(b.metadata['edge_label_index'])
      label = np.asarray(b.metadata['edge_label'])
      user, item = b.node['user'].numpy(), b.node['item'].numpy()
      for i in np.nonzero(label == 1)[0]:
        assert (int(user[eli[0, i]]), int(item[eli[1, i]])) in pos
  finally:
    loader.shutdown()
