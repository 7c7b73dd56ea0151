"""The port's out-of-core store (``graphlearn_tpu_torch.storage``) against
the JAX package's, on the CPU.

Ports ``tests/test_storage.py``'s store tests (the hetero and distributed
ones come with their slices) at JAX's sizes (N = 96, F = 6), each holding
the port against JAX on the same numpy inputs:

- ``DiskTier``: the round trip in both layouts, the streaming write, and
  a tier written by either package read by the other, bytes equal;
- ``TieredFeature`` lookups and ``cpu_get`` exactly equal to JAX's over
  the (hot, warm) grid, pad ids included, with ``prefetch_miss`` counted
  as JAX counts it; the hotness remap, the IPC handle (the disk tier by
  its path) and ``feature_array`` raising;
- ``ChunkStager``: slabs equal to JAX's, the degraded path (a stalled and
  a raising worker) giving the same bytes, the watermarks, a closed
  stager's next epoch staging asynchronously again, and a ring slot
  refilled only after its chunk's ack.
"""
import threading
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu import metrics as jmetrics
from graphlearn_tpu import storage as jstorage
from graphlearn_tpu_torch import metrics as tmetrics
from graphlearn_tpu_torch import storage as tstorage

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F = 96, 6
CPU = 'cpu'
GRID = [(0, 40), (16, 30), (0, 0), (N, 0)]


def _feat(n=N, f=F, seed=0):
  return np.random.default_rng(seed).standard_normal((n, f)).astype(
      np.float32)


def _misses(pkg_metrics):
  return pkg_metrics.default_registry().counters().get(
      'storage.prefetch_miss', 0)


# ------------------------------------------------------------------- disk


@pytest.mark.parametrize('fmt', ['npy', 'raw'])
def test_disk_tier_roundtrip(tmp_path, fmt):
  arr = np.arange(100 * 5, dtype=np.float32).reshape(100, 5)
  t = tstorage.DiskTier.write(str(tmp_path / fmt), arr, rows_per_chunk=17,
                              fmt=fmt)
  assert t.shape == (100, 5) and t.num_chunks == 6 and t.nbytes == arr.nbytes
  ids = np.array([0, 99, 17, 16, 5, 5, 50, 84])   # chunk-boundary mix
  np.testing.assert_array_equal(t.gather(ids), arr[ids])
  t2 = tstorage.DiskTier(str(tmp_path / fmt))     # reopened from meta alone
  np.testing.assert_array_equal(t2.gather(ids), arr[ids])
  with pytest.raises(IndexError):
    t.gather(np.array([100]))
  with pytest.raises(ValueError):
    tstorage.DiskTier.create_empty(str(tmp_path / 'bad'), 4, 4, np.float32,
                                   fmt='hdf5')


def test_disk_tier_streaming_write(tmp_path):
  arr = np.random.default_rng(1).standard_normal((50, 4)).astype(np.float32)
  t = tstorage.DiskTier.create_empty(str(tmp_path / 'w'), 50, 4, np.float32,
                                     rows_per_chunk=16, fmt='raw')
  t.write_rows(10, arr[10:45])     # crosses three chunk files
  np.testing.assert_array_equal(t.gather(np.arange(10, 45)), arr[10:45])
  np.testing.assert_array_equal(t.gather(np.array([0, 49])),
                                np.zeros((2, 4), np.float32))
  with pytest.raises(IndexError, match='past tier end'):
    t.write_rows(45, arr[:10])


@pytest.mark.parametrize('fmt', ['npy', 'raw'])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_disk_tier_written_by_either_package_reads_in_the_other(
    tmp_path, fmt, writer):
  arr = _feat(70, 3, seed=2)
  w, r = ((jstorage, tstorage) if writer == 'jax' else (tstorage, jstorage))
  w.DiskTier.write(str(tmp_path / 't'), arr, rows_per_chunk=32, fmt=fmt)
  t = r.DiskTier(str(tmp_path / 't'))
  assert (t.rows, t.dim, t.dtype, t.num_chunks, t.fmt) == (70, 3,
                                                           np.float32, 3,
                                                           fmt)
  ids = np.array([69, 0, 31, 32, 64, 5])
  np.testing.assert_array_equal(t.gather(ids), arr[ids])
  np.testing.assert_array_equal(t.gather(np.arange(70)), arr)
  # the spill function lands the same files
  a = jstorage.spill_array(str(tmp_path / 'a'), arr, rows_per_chunk=32,
                           fmt=fmt)
  b = tstorage.spill_array(str(tmp_path / 'b'), arr, rows_per_chunk=32,
                           fmt=fmt)
  for c in range(3):
    name = f'chunk_{c:05d}.{fmt}'
    assert (tmp_path / 'a' / name).read_bytes() == \
        (tmp_path / 'b' / name).read_bytes()
  assert a.shape == b.shape


# ---------------------------------------------------------------- tiered


@pytest.mark.parametrize('hot,warm', GRID)
def test_tiered_feature_matches_jax(tmp_path, hot, warm):
  feat = _feat()
  jtf = jstorage.TieredFeature(feat, hot_rows=hot, warm_rows=warm,
                               spill_dir=str(tmp_path / 'j'))
  tf = tstorage.TieredFeature(feat, hot_rows=hot, warm_rows=warm,
                              spill_dir=str(tmp_path / 't'), device=CPU)
  assert tf.shape == jtf.shape == (N, F) and len(tf) == N
  assert tf.tier_occupancy() == jtf.tier_occupancy()
  ids = np.array([0, 15, 16, 45, 46, 95, 50, 5, -1, -1], np.int32)
  j0, t0 = _misses(jmetrics), _misses(tmetrics)
  for _ in range(2):        # the second lookup hits the promoted cache
    np.testing.assert_array_equal(tf[ids].numpy(), np.asarray(jtf[ids]))
    np.testing.assert_array_equal(tf[torch.as_tensor(ids)].numpy(),
                                  np.asarray(jtf[ids]))
    assert _misses(tmetrics) - t0 == _misses(jmetrics) - j0
  if 0 < hot < N:
    assert tf._unified._last_cold_cap == jtf._unified._last_cold_cap
  np.testing.assert_array_equal(tf.cpu_get(np.abs(ids)),
                                jtf.cpu_get(np.abs(ids)))
  np.testing.assert_array_equal(tf.cpu_get(np.abs(ids)), feat[np.abs(ids)])
  assert tf.tier_occupancy() == jtf.tier_occupancy()
  assert (tf.device_table() is not None) == (hot == N) == \
      (jtf.device_table() is not None)
  # the staging read path, past the hot tier
  rows = np.arange(hot, N, 7)
  if rows.size:
    np.testing.assert_array_equal(tf.stage_gather(rows),
                                  jtf.stage_gather(rows))
  if hot:
    with pytest.raises(IndexError, match='hot_rows'):
      tf.stage_gather(np.array([0]))


def test_tiered_feature_from_a_disk_tier_and_all_on_disk(tmp_path):
  feat = _feat()
  jstorage.spill_array(str(tmp_path / 'all'), feat, rows_per_chunk=20)
  jtf = jstorage.TieredFeature(str(tmp_path / 'all'), hot_rows=10,
                               warm_rows=20)
  tf = tstorage.TieredFeature(str(tmp_path / 'all'), hot_rows=10,
                              warm_rows=20, device=CPU)
  assert tf.tier_occupancy() == jtf.tier_occupancy()
  ids = np.array([95, 0, 9, 10, 29, 30, 31, -1])
  np.testing.assert_array_equal(tf[ids].numpy(), np.asarray(jtf[ids]))
  cold = tstorage.TieredFeature(feat, hot_rows=0, warm_rows=0,
                                spill_dir=str(tmp_path / 'cold'), device=CPU)
  assert cold.disk_rows == N and cold.shape == (N, F)
  np.testing.assert_array_equal(cold[ids].numpy(),
                                feat[np.maximum(ids, 0) * (ids >= 0)])
  with pytest.raises(ValueError, match='spill_dir'):
    tstorage.TieredFeature(feat, hot_rows=8, warm_rows=8, device=CPU)
  with pytest.raises(ValueError, match='hot_rows >= 1'):
    cold.scan_tables()


def test_tiered_feature_id2index_ipc_and_no_resident_table(tmp_path):
  row = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1, 2, 4, 5])
  col = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 7, 7, 7, 3, 3])
  topo = gtt.data.Topology(np.stack([row, col]), layout='CSR', num_nodes=10)
  jtopo = glt.data.Topology(np.stack([row, col]), layout='CSR', num_nodes=10)
  feat = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
  reordered, id2index = gtt.data.sort_by_in_degree(feat, 0.3, topo)
  jre, jid2index = glt.data.sort_by_in_degree(feat, 0.3, jtopo)
  np.testing.assert_array_equal(id2index, jid2index)
  tf = tstorage.TieredFeature(reordered, hot_rows=2, warm_rows=3,
                              id2index=id2index, spill_dir=str(tmp_path / 't'),
                              device=CPU)
  jtf = jstorage.TieredFeature(jre, hot_rows=2, warm_rows=3,
                               id2index=jid2index,
                               spill_dir=str(tmp_path / 'j'))
  ids = np.array([7, 3, 5, 0, 9], np.int32)
  np.testing.assert_array_equal(tf[ids].numpy(), feat[ids])
  np.testing.assert_array_equal(tf[ids].numpy(), np.asarray(jtf[ids]))
  np.testing.assert_array_equal(tf.cpu_get(ids), feat[ids])
  # an id past the remap reads the fill row, as Feature's lookup does
  assert torch.isnan(tf[np.array([10])]).all()
  handle = tf.share_ipc()
  assert handle[1] == str(tmp_path / 't')     # the disk tier by its path
  clone = tstorage.TieredFeature.from_ipc_handle(handle)
  np.testing.assert_array_equal(clone[ids].numpy(), feat[ids])
  assert clone.tier_occupancy() == tf.tier_occupancy()
  import pickle
  again = pickle.loads(pickle.dumps(tf))
  np.testing.assert_array_equal(again[ids].numpy(), feat[ids])
  with pytest.raises(AttributeError):
    _ = tf.feature_array     # no resident full table, by design
  with pytest.raises(ValueError, match='not a TieredFeature'):
    tstorage.TieredFeature.from_ipc_handle(('other',) + handle[1:])


def test_tiered_store_through_the_loader_matches_the_all_ram_store(tmp_path):
  """A loader over a TieredFeature gathers x through its lookup: the
  batches equal those of the all-RAM Feature loader and of JAX's tiered
  loader."""
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  feat = rng.standard_normal((N, F)).astype(np.float32)

  def port(tiered):
    ds = gtt.data.Dataset(device=CPU)
    ds.init_graph(np.stack([rows, cols]), num_nodes=N)
    if tiered:
      ds.node_features = tstorage.TieredFeature(
          feat, hot_rows=16, warm_rows=30, spill_dir=str(tmp_path / 't'),
          device=CPU)
    else:
      ds.init_node_features(feat)
    return gtt.loader.NeighborLoader(ds, [3, 2], np.arange(24),
                                     batch_size=8, dedup='tree', seed=0,
                                     device=CPU)

  jds = glt.data.Dataset()
  jds.init_graph(np.stack([rows, cols]), graph_mode='CPU', num_nodes=N)
  jds.node_features = jstorage.TieredFeature(
      feat, hot_rows=16, warm_rows=30, spill_dir=str(tmp_path / 'j'))
  jl = glt.loader.NeighborLoader(jds, [3, 2], np.arange(24), batch_size=8,
                                 dedup='tree', seed=0)
  for a, b, c in zip(port(False), port(True), jl):
    np.testing.assert_array_equal(b.x.numpy(), a.x.numpy())
    np.testing.assert_array_equal(b.x.numpy(), np.asarray(c.x))


@pytest.mark.parametrize('dedup', ['tree', 'merge'])
def test_tiered_feature_hetero_loader_matches_jax(tmp_path, dedup):
  """tests/test_storage.py:test_tiered_feature_hetero_loader_parity on the
  port: per-type TieredFeature stores (hot, warm and disk rows) in a
  typed dataset, collated through the typed loader's store lookup; the
  batches equal the all-RAM Feature loader's and JAX's tiered loader's,
  on a user/item graph and on a larger paper/author one."""
  from test_torch_hetero_sampler import typed_edges
  ub = ('user', 'buys', 'item')
  bu = ('item', 'rev_buys', 'user')
  small = ({ub: np.array([[0, 1, 2, 3], [0, 0, 1, 1]]),
            bu: np.array([[0, 0, 1, 1], [0, 1, 2, 3]])},
           {ub: 4, bu: 2}, {'user': 4, 'item': 2},
           {ub: [2], bu: [2]}, ('user', np.arange(4)), 2,
           dict(hot_rows=1, warm_rows=1))
  edges, nodes, _ = typed_edges(with_tags=False)
  large = (edges, nodes, {'paper': 120, 'author': 70},
           {et: [3, 2] for et in edges}, ('paper', np.arange(0, 120, 3)),
           8, dict(hot_rows=30, warm_rows=30))
  rng = np.random.default_rng(3)
  for case, (ei, num_nodes, sizes, fan, seeds, b, split) in enumerate(
      (small, large)):
    nfeat = {t: rng.standard_normal((n, 5)).astype(np.float32)
             for t, n in sizes.items()}

    def port(tiered):
      ds = gtt.data.Dataset(edge_dir='out', device=CPU)
      ds.init_graph(ei, num_nodes=num_nodes)
      if tiered:
        ds.node_features = {
            t: tstorage.TieredFeature(
                v, spill_dir=str(tmp_path / f't{case}_{t}'), device=CPU,
                **split)
            for t, v in nfeat.items()}
      else:
        ds.init_node_features({t: v.copy() for t, v in nfeat.items()})
      return gtt.loader.NeighborLoader(ds, fan, seeds, batch_size=b,
                                       seed=0, dedup=dedup, device=CPU)

    jds = glt.data.Dataset(edge_dir='out')
    jds.init_graph(ei, graph_mode='CPU', num_nodes=num_nodes)
    jds.node_features = {
        t: jstorage.TieredFeature(v, spill_dir=str(tmp_path / f'j{case}_{t}'),
                                  **split)
        for t, v in nfeat.items()}
    jl = glt.loader.NeighborLoader(jds, fan, seeds, batch_size=b, seed=0,
                                   dedup=dedup)
    n = 0
    for a, t, j in zip(port(False), port(True), jl):
      assert sorted(t.x) == sorted(a.x) == sorted(j.x)
      for k in a.x:
        np.testing.assert_array_equal(t.x[k].numpy(), a.x[k].numpy())
        np.testing.assert_array_equal(t.x[k].numpy(), np.asarray(j.x[k]))
        np.testing.assert_array_equal(t.node[k].numpy(),
                                      np.asarray(j.node[k]))
      n += 1
    assert n == len(seeds[1]) // b


# ---------------------------------------------------------------- stager


def _stores(tmp_path):
  feat = _feat(64, 4)
  kw = dict(hot_rows=8, warm_rows=8)
  return (feat, jstorage.TieredFeature(feat, spill_dir=str(tmp_path / 'j'),
                                       **kw),
          tstorage.TieredFeature(feat, spill_dir=str(tmp_path / 't'),
                                 device=CPU, **kw))


def test_stager_slabs_match_jax(tmp_path):
  feat, jtf, tf = _stores(tmp_path)
  plan = [np.arange(20, 40, dtype=np.int64), np.array([8, 9, 63]),
          np.zeros((0,), np.int64), np.arange(16, 64, dtype=np.int64)]
  js = jstorage.ChunkStager(jtf, max_ahead=2, timeout_s=10.0)
  ts = tstorage.ChunkStager(tf, max_ahead=2, timeout_s=10.0)
  js.begin_epoch(plan)
  ts.begin_epoch(plan)
  staged0 = tmetrics.default_registry().counters().get(
      'storage.staged_rows', 0)
  for c in range(len(plan)):
    jids, jrows = js.take(c)
    ids, rows = ts.take(c)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(rows.numpy(), jrows)
    assert ids.shape[0] == tstorage.pow2_slab_cap(plan[c].shape[0])
    assert ts.watermarks() == js.watermarks()
    js.ack(c)
    ts.ack(c)
  assert not ts.degraded and not js.degraded
  assert tmetrics.default_registry().counters()['storage.staged_rows'] - \
      staged0 == sum(p.shape[0] for p in plan)
  # each slot refilled only once its previous chunk had been acked
  assert [c for c, _ in ts.refills] == [0, 1, 2, 3]
  assert all(done for _, done in ts.refills)
  for s in (js, ts):
    s.close()
  with pytest.raises(ValueError, match='start_chunk'):
    ts.begin_epoch(plan, start_chunk=7)
  ts.close()
  ids, rows = tstorage.pad_slab(np.array([3, 5, 9]), feat[[3, 5, 9]])
  jids, jrows = jstorage.pad_slab(np.array([3, 5, 9]), feat[[3, 5, 9]])
  np.testing.assert_array_equal(ids, jids)
  np.testing.assert_array_equal(rows, jrows)
  assert [tstorage.pow2_slab_cap(n) for n in (0, 1, 2, 3, 1025)] == \
      [jstorage.pow2_slab_cap(n) for n in (0, 1, 2, 3, 1025)]


def test_stager_degrades_on_timeout_and_on_a_raising_worker(tmp_path):
  """A stalled worker trips the take() timeout and the consumer gathers
  synchronously (the same bytes, counted in prefetch_miss); a raising
  worker degrades the same way; a stager closed mid-epoch stages its next
  epoch asynchronously again."""
  feat, _, tf = _stores(tmp_path)
  rows = np.arange(20, 40, dtype=np.int64)
  stager = tstorage.ChunkStager(tf, max_ahead=1, timeout_s=0.2)
  stager._stage_fault = lambda: time.sleep(1.0)
  miss0 = _misses(tmetrics)
  stager.begin_epoch([rows])
  ids, slab = stager.take(0)
  assert stager.degraded
  assert _misses(tmetrics) - miss0 == rows.shape[0]
  valid = ids.numpy() != np.iinfo(np.int32).max
  np.testing.assert_array_equal(slab.numpy()[valid.nonzero()[0]], feat[rows])
  stager.ack(0)
  stager.close()

  def boom():
    raise RuntimeError('injected staging fault')

  stager2 = tstorage.ChunkStager(tf, max_ahead=1, timeout_s=10.0)
  stager2._stage_fault = boom
  stager2.begin_epoch([rows])
  ids2, slab2 = stager2.take(0)
  assert stager2.degraded
  np.testing.assert_array_equal(slab2.numpy(), slab.numpy())
  np.testing.assert_array_equal(ids2.numpy(), ids.numpy())
  stager2.close()

  stager3 = tstorage.ChunkStager(tf, max_ahead=1, timeout_s=10.0)
  stager3.begin_epoch([rows, rows + 1])
  stager3.take(0)           # queues chunk 1
  stager3.close()           # chunk 1 (or the sentinel) still queued
  stager3.begin_epoch([rows])
  ids3, _ = stager3.take(0)
  assert not stager3.degraded
  np.testing.assert_array_equal(ids3.numpy(), ids2.numpy())
  stager3.close()


class _Held:
  """A stand-in for a copy's CUDA event: done once set."""

  def __init__(self):
    self._done = threading.Event()

  def query(self):
    return self._done.is_set()

  def set(self):
    self._done.set()


def test_stager_refills_a_slot_only_after_its_release_event(tmp_path):
  """Chunk c + max_ahead + 1 shares chunk c's ring slot: the worker does
  not write it while chunk c's release event (the copy's) is pending, and
  writes it once the event completes."""
  feat, _, tf = _stores(tmp_path)
  plan = [np.arange(16, 24), np.arange(24, 32), np.arange(32, 40)]
  stager = tstorage.ChunkStager(tf, max_ahead=1, timeout_s=10.0)
  stager.begin_epoch(plan)
  ids0, rows0 = stager.take(0)       # submits chunk 1 (slot 1)
  ev = _Held()
  stager.ack(0, ev)
  ids1, _ = stager.take(1)           # submits chunk 2, which needs slot 0
  time.sleep(0.3)
  assert 2 not in stager.stage_done_t, 'slot 0 refilled before its event'
  np.testing.assert_array_equal(ids0.numpy(), np.arange(16, 24))
  np.testing.assert_array_equal(rows0.numpy(), feat[16:24])
  ev.set()
  ids2, rows2 = stager.take(2)
  assert not stager.degraded
  np.testing.assert_array_equal(ids2.numpy(), np.arange(32, 40))
  np.testing.assert_array_equal(rows2.numpy(), feat[32:40])
  assert ids2.data_ptr() == ids0.data_ptr()     # the same slot, refilled
  stager.close()
