"""The port's feature store and data layer against the JAX package's, on
the CPU, exact: every homogeneous case of ``tests/test_feature.py`` (the
split at 0.0 / 0.4 / 1.0, host-only, the degree sort, the mixed
``UnifiedTensor`` and its edge cases, only cold rows shipped, the IPC
round trip, the homogeneous ``Dataset``); the hot/cold gather (the
kernel's plain version, the CPU route) against JAX's mixed path over
random splits, id sets (FILL pads, repeats, all hot, all cold) and
dtypes, ``_last_cold_cap`` included; the hot/cold kernel's scratch
size and its 32-bit limits; ``reorder``; a ``NeighborLoader``
batch over a hot/cold store; and the epoch trainers refusing one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

CPU = 'cpu'


def make_feat(n=40, f=8):
  return (np.arange(n, dtype=np.float32)[:, None]
          * np.ones((1, f), np.float32))


def np_rows(t):
  t = torch.as_tensor(t)
  return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_rows(a):
  a = np.asarray(a)
  return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


# ------------------------------------------- tests/test_feature.py cases


@pytest.mark.parametrize('split_ratio', [0.0, 0.4, 1.0])
def test_feature_lookup(split_ratio):
  feat = make_feat()
  jstore = glt.data.Feature(feat, split_ratio=split_ratio)
  store = gtt.data.Feature(feat, split_ratio=split_ratio, device=CPU)
  ids = np.array([0, 5, 39, 17], dtype=np.int32)
  got = store[ids].numpy()
  np.testing.assert_array_equal(got, np.asarray(jstore[ids]))
  np.testing.assert_array_equal(got, feat[ids])
  assert store.unified.host_rows == jstore.unified.host_rows
  assert (store.device_table() is None) == (jstore.device_table() is None)


def test_feature_default_split_is_all_host():
  feat = make_feat()
  store = gtt.data.Feature(feat, device=CPU)
  assert store.split_ratio == 0.0
  assert store.unified.host_rows == 40 and store.device_table() is None


def test_feature_host_only():
  feat = make_feat()
  jstore = glt.data.Feature(feat, split_ratio=0.8, with_device=False)
  store = gtt.data.Feature(feat, split_ratio=0.8, with_device=False,
                           device=CPU)
  ids = np.array([3, 2, 1], np.int32)
  np.testing.assert_array_equal(store[ids].numpy(), np.asarray(jstore[ids]))
  np.testing.assert_array_equal(store.cpu_get(ids), jstore.cpu_get(ids))
  assert store.unified.device_part is None and store.unified.host_rows == 40


def test_feature_with_degree_sort():
  row = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1, 2, 4, 5])
  col = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 7, 7, 7, 3, 3])
  ei = np.stack([row, col])
  jtopo = glt.data.Topology(ei, layout='CSR', num_nodes=10)
  topo = gtt.data.Topology(ei, layout='CSR', num_nodes=10)
  feat = make_feat(10, 4)
  jre, jid = glt.data.sort_by_in_degree(feat, 0.3, jtopo)
  re, id2index = gtt.data.sort_by_in_degree(feat, 0.3, topo)
  np.testing.assert_array_equal(re, jre)
  np.testing.assert_array_equal(id2index, jid)
  assert id2index[7] == 0 and id2index[3] == 1
  jstore = glt.data.Feature(jre, split_ratio=0.3, id2index=jid)
  store = gtt.data.Feature(re, split_ratio=0.3, id2index=id2index,
                           device=CPU)
  ids = np.array([7, 3, 5, 0, -1, 9], np.int32)
  np.testing.assert_array_equal(store[ids].numpy(), np.asarray(jstore[ids]))
  np.testing.assert_array_equal(store[ids[:4]].numpy(), feat[ids[:4]])
  np.testing.assert_array_equal(store.cpu_get(ids[:4]),
                                jstore.cpu_get(ids[:4]))


def test_unified_tensor_mixed():
  feat = make_feat(20, 4)
  jut = glt.data.UnifiedTensor().init_from(feat[:8], feat[8:])
  ut = gtt.data.UnifiedTensor(CPU).init_from(feat[:8], feat[8:])
  assert ut.shape == jut.shape == (20, 4)
  assert ut.size == 20 and ut.host_rows == 12
  ids = np.array([0, 7, 8, 19, 4, 12], np.int32)
  np.testing.assert_array_equal(ut[ids].numpy(), np.asarray(jut[ids]))
  assert ut._last_cold_cap == jut._last_cold_cap == 4


@pytest.mark.parametrize('ids', [[0, 7, 3, 1], [8, 19, 12, 9], [19],
                                 [5, 5, 15, 15]],
                         ids=['all_hot', 'all_cold', 'single', 'repeats'])
def test_unified_tensor_mixed_edge_cases(ids):
  feat = make_feat(20, 4)
  jut = glt.data.UnifiedTensor().init_from(feat[:8], feat[8:])
  ut = gtt.data.UnifiedTensor(CPU).init_from(feat[:8], feat[8:])
  ids = np.array(ids, np.int32)
  np.testing.assert_array_equal(ut[ids].numpy(), np.asarray(jut[ids]))
  np.testing.assert_array_equal(ut[ids].numpy(), feat[ids])
  assert ut._last_cold_cap == jut._last_cold_cap


def test_unified_tensor_ships_only_cold_rows():
  feat = make_feat(1000, 16)
  jut = glt.data.UnifiedTensor().init_from(feat[:900], feat[900:])
  ut = gtt.data.UnifiedTensor(CPU).init_from(feat[:900], feat[900:])
  ids = np.arange(256, dtype=np.int32)
  ids[:4] = [900, 950, 999, 901]
  np.testing.assert_array_equal(ut[ids].numpy(), np.asarray(jut[ids]))
  assert ut._last_cold_cap == jut._last_cold_cap == 4


def test_device_group_of_one_places_the_hot_block():
  feat = make_feat(64, 8)
  group = gtt.data.DeviceGroup(0, [torch.device(CPU)])
  assert group.size == 1 and group.group_id == 0
  store = gtt.data.Feature(feat, split_ratio=0.5, device_group_list=[group])
  assert store.device == torch.device(CPU)
  ids = np.array([0, 40, 17, 63], np.int32)
  np.testing.assert_array_equal(store[ids].numpy(), feat[ids])


@pytest.mark.parametrize('split_ratio', [0.0, 0.5, 1.0])
def test_feature_ipc_roundtrip(split_ratio):
  feat = make_feat(10, 4)
  jstore = glt.data.Feature(feat, split_ratio=split_ratio)
  jclone = glt.data.Feature.from_ipc_handle(jstore.share_ipc())
  store = gtt.data.Feature(feat, split_ratio=split_ratio, device=CPU)
  clone = gtt.data.Feature.from_ipc_handle(store.share_ipc())
  ids = np.array([9, 0, 4], np.int32)
  np.testing.assert_array_equal(clone[ids].numpy(), np.asarray(jclone[ids]))
  np.testing.assert_array_equal(clone.cpu_get(ids), jclone.cpu_get(ids))
  assert clone.shape == jclone.shape and len(clone) == len(jclone) == 10
  # the clone shares the parts; a host part went into shared memory
  assert clone.unified.device_part is store.unified.device_part
  if store.unified.host_rows:
    assert store.unified.host_part.is_shared()
    assert clone.unified.host_part is store.unified.host_part


def test_feature_pickles_as_its_ipc_handle():
  import pickle
  feat = make_feat(12, 3)
  _, id2index = gtt.data.sort_by_in_degree(
      feat, 0.5, gtt.data.Topology(np.array([[0, 1], [5, 5]]), num_nodes=12))
  store = gtt.data.Feature(feat[np.argsort(id2index)], split_ratio=0.5,
                           id2index=id2index, device=CPU)
  clone = pickle.loads(pickle.dumps(store))
  ids = np.arange(12)
  np.testing.assert_array_equal(clone[ids].numpy(), feat)


def test_dataset_homo():
  row = np.array([0, 0, 1, 2, 3])
  col = np.array([1, 2, 2, 3, 0])
  feat = make_feat(4, 4)
  labels = np.array([0, 1, 0, 1])
  jds = glt.data.Dataset()
  jds.init_graph(np.stack([row, col]), graph_mode='CPU')
  jds.init_node_features(feat, sort_func=glt.data.sort_by_in_degree,
                         split_ratio=0.5)
  jds.init_node_labels(labels)
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(np.stack([row, col]), graph_mode='CPU')
  ds.init_node_features(feat, sort_func=gtt.data.sort_by_in_degree,
                        split_ratio=0.5)
  ds.init_node_labels(labels)
  assert not ds.is_hetero and ds.get_graph().num_edges == 5
  assert ds.get_graph().mode == 'CPU'
  assert ds.get_node_types() is None and ds.get_edge_types() is None
  np.testing.assert_array_equal(ds.get_node_feature().id2index,
                                jds.get_node_feature().id2index)
  ids = np.array([2, 0], np.int32)
  np.testing.assert_array_equal(ds.node_features[ids].numpy(),
                                np.asarray(jds.node_features[ids]))
  np.testing.assert_array_equal(ds.get_node_label().numpy(),
                                jds.get_node_label())
  assert ds.node_features.unified.host_rows == 2
  assert ds.share_ipc() is ds


# ------------------------------------ the hot/cold gather over random cases


DTYPES = {'f32': (None, None), 'bf16': (torch.bfloat16, jnp.bfloat16),
          'int32': (None, None)}


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('seed', range(4))
def test_hot_cold_gather_matches_jax_mixed_path(dtype, seed):
  """UnifiedTensor lookups (the kernel's plain version) against JAX's
  mixed path over random splits (H = 1 .. N - 1) and id sets: random,
  repeats, all hot, all cold; exact, with the same shipped block."""
  rng = np.random.default_rng(seed)
  n, f = int(rng.integers(20, 200)), int(rng.integers(1, 9))
  table = (rng.integers(-1000, 1000, (n, f)).astype(np.int32)
           if dtype == 'int32' else
           rng.standard_normal((n, f)).astype(np.float32))
  h = int(rng.integers(1, n))
  tdt, jdt = DTYPES[dtype]
  jut = glt.data.UnifiedTensor(dtype=jdt).init_from(table[:h], table[h:])
  ut = gtt.data.UnifiedTensor(CPU, tdt).init_from(table[:h], table[h:])
  b = int(rng.integers(1, 300))
  cases = [rng.integers(0, n, b), np.repeat(rng.integers(0, n, 3), b),
           rng.integers(0, h, b), rng.integers(h, n, b)]
  for ids in cases:
    ids = ids.astype(np.int32)
    got = ut[ids]
    assert got.dtype == (tdt or torch.from_numpy(table).dtype)
    np.testing.assert_array_equal(np_rows(got), jax_rows(jut[ids]))
    assert ut._last_cold_cap == jut._last_cold_cap


@pytest.mark.parametrize('split_ratio', [0.0, 0.3, 0.7, 1.0])
def test_feature_pads_and_remap_match_jax(split_ratio):
  """Feature lookups with FILL pads (storage row 0 after the remap),
  repeats and a degree reorder, at the split's every side."""
  rng = np.random.default_rng(3)
  n, f = 60, 5
  feat = rng.standard_normal((n, f)).astype(np.float32)
  ei = np.stack([rng.integers(0, n, 200), rng.zipf(1.5, 200) % n])
  re, id2index = gtt.data.sort_by_in_degree(
      feat, split_ratio, gtt.data.Topology(ei, num_nodes=n))
  jstore = glt.data.Feature(re, split_ratio=split_ratio, id2index=id2index)
  store = gtt.data.Feature(re, split_ratio=split_ratio, id2index=id2index,
                           device=CPU)
  ids = rng.integers(0, n, 64)
  ids[::7] = -1
  ids[5:9] = ids[4]
  np.testing.assert_array_equal(store[ids].numpy(), np.asarray(jstore[ids]))


def test_plain_gather_all_host_ships_the_rows_whole():
  table = torch.arange(30, dtype=torch.float32).reshape(10, 3)
  hot = table[:0]
  rows, cap = ops.gather_rows_unified_plain(hot, table, torch.tensor(
      [9, 0, -4, 12]))
  assert cap is None
  np.testing.assert_array_equal(rows.numpy(), table[[9, 0, 0, 9]].numpy())
  np.testing.assert_array_equal(
      ops.gather_rows_unified(hot, table, torch.tensor([3, 3])).numpy(),
      table[[3, 3]].numpy())


@pytest.mark.parametrize('n_ids,n_cold,cap', [
    (937_984, 750_000, 2_097_152), (7_936, 100, 256), (5, 0, 0), (1, 1, 2),
    (3, 1_000_000, 8)])
def test_unified_scratch_keeps_the_table_at_most_half_full(n_ids, n_cold,
                                                           cap):
  """The hot/cold kernel's scratch: a power-of-two table at least twice
  the cold rows a call can name (none without a cold part), two
  counters, the table's keys and winners and a duplicate list of one
  pair a slot."""
  got, words = ops.gather.unified_scratch(n_ids, n_cold, 'lookup')
  assert got == cap
  assert words == (2 if n_cold == 0 else 2 + 2 * cap + 2 * n_ids)
  if n_cold:
    assert cap >= 2 * min(n_ids, n_cold) and cap & (cap - 1) == 0


def test_unified_scratch_refuses_counts_past_32_bits():
  with pytest.raises(ValueError, match='host part has 2147483648 rows'):
    ops.gather.unified_scratch(4, 2 ** 31, 'gather_rows_unified')
  with pytest.raises(ValueError, match='2147483648 ids in one call'):
    ops.gather.unified_scratch(2 ** 31, 5, 'gather_rows_unified')
  assert ops.gather.unified_scratch(2 ** 31 - 1, 0, 'x') == (0, 2)


# -------------------------------------------------------------- reorder


def _topos(layout):
  rng = np.random.default_rng(11)
  n = 50
  ei = np.stack([rng.integers(0, n, 300), rng.zipf(1.4, 300) % n])
  return (glt.data.Topology(ei, layout=layout, num_nodes=n),
          gtt.data.Topology(ei, layout=layout, num_nodes=n), n)


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
def test_in_degree_hotness_and_sort(layout):
  jtopo, topo, n = _topos(layout)
  np.testing.assert_array_equal(gtt.data.in_degree_hotness(topo, n),
                                glt.data.in_degree_hotness(jtopo, n))
  feat = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
  for a, b in zip(gtt.data.sort_by_in_degree(feat, 0.2, topo),
                  glt.data.sort_by_in_degree(feat, 0.2, jtopo)):
    np.testing.assert_array_equal(a, b)


def test_frequency_hotness():
  rng = np.random.default_rng(2)
  batches = [rng.integers(-3, 70, 40) for _ in range(5)]
  np.testing.assert_array_equal(gtt.data.frequency_hotness(batches, 64),
                                glt.data.frequency_hotness(batches, 64))


# ----------------------------------------------------- loader and trainers


def _mixed_datasets(n=16, f=4):
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(n), 3)
  cols = (rows + rng.integers(1, n, rows.shape[0])) % n
  feat = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, f),
                                                           np.float32)
  jds = glt.data.Dataset()
  jds.init_graph(np.stack([rows, cols]), graph_mode='CPU', num_nodes=n)
  jds.init_node_features(feat, sort_func=glt.data.sort_by_in_degree,
                         split_ratio=0.5)
  jds.init_node_labels(np.arange(n) % 3)
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(np.stack([rows, cols]), graph_mode='CPU', num_nodes=n)
  ds.init_node_features(feat, sort_func=gtt.data.sort_by_in_degree,
                        split_ratio=0.5)
  ds.init_node_labels(np.arange(n) % 3)
  return jds, ds, feat


@pytest.mark.parametrize('dedup', ['tree', 'auto'])
def test_neighbor_loader_over_a_hot_cold_store_matches_jax(dedup):
  jds, ds, feat = _mixed_datasets()
  assert ds.node_features.device_table() is None
  jl = glt.loader.NeighborLoader(jds, [2, 2], np.arange(16), batch_size=4,
                                 shuffle=True, seed=0, dedup=dedup)
  tl = gtt.loader.NeighborLoader(ds, [2, 2], np.arange(16), batch_size=4,
                                 shuffle=True, seed=0, dedup=dedup,
                                 to_device=CPU)
  jb, tb = list(jl), list(tl)
  assert len(jb) == len(tb) == 4
  for a, b in zip(jb, tb):
    np.testing.assert_array_equal(b.node.numpy(), np.asarray(a.node))
    np.testing.assert_array_equal(b.x.numpy(), np.asarray(a.x))
    np.testing.assert_array_equal(b.y.numpy(), np.asarray(a.y))
    n = int(b.num_nodes)
    np.testing.assert_array_equal(b.x[:n].numpy(), feat[b.node[:n].numpy()])


def test_edge_features_on_the_host_match_jax():
  rng = np.random.default_rng(5)
  n = 20
  ei = np.stack([rng.integers(0, n, 60), rng.integers(0, n, 60)])
  efeat = rng.standard_normal((60, 3)).astype(np.float32)
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=n)
  jds.init_node_features(make_feat(n, 2))
  jds.init_edge_features(efeat, split_ratio=0.25)
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(make_feat(n, 2))
  ds.init_edge_features(efeat, split_ratio=0.25)
  assert ds.edge_features.device_table() is None
  jl = glt.loader.NeighborLoader(jds, [3], np.arange(8), batch_size=4,
                                 with_edge=True, seed=1)
  tl = gtt.loader.NeighborLoader(ds, [3], np.arange(8), batch_size=4,
                                 with_edge=True, seed=1, device=CPU)
  for a, b in zip(jl, tl):
    np.testing.assert_array_equal(b.edge_attr.numpy(),
                                  np.asarray(a.edge_attr))


@pytest.mark.parametrize('trainer', ['ScanTrainer', 'RunTrainer',
                                     'OverlappedTrainer',
                                     'FusedEpochTrainer'])
def test_epoch_trainers_refuse_a_hot_cold_store(trainer):
  jds, ds, _ = _mixed_datasets()
  loader = gtt.loader.NeighborLoader(ds, [2, 2], np.arange(16),
                                     batch_size=4, device=CPU)
  model = gtt.models.GraphSAGE(4, 8, 3, num_layers=2, device=CPU)
  with pytest.raises(ValueError, match='TieredScanTrainer'):
    getattr(gtt.loader, trainer)(loader, model, 3)
  jloader = glt.loader.NeighborLoader(jds, [2, 2], np.arange(16),
                                      batch_size=4)
  with pytest.raises(ValueError, match='TieredScanTrainer'):
    glt.loader.ScanTrainer(jloader, None, None, 3)
