"""A ``DeviceGroup`` of several devices: the port's row-sharded hot table
against the JAX package's, on the CPU, exact.

The port's ``DeviceGroup(0, ['cpu'] * 4)`` against JAX's
``DeviceGroup(0, jax.devices()[:4])`` (``tests/conftest.py`` gives JAX 8
CPU devices): full splits at 64 rows and at 66 (padded up to 68 with
zero rows), mixed splits (rounded down, the demoted rows on the host,
``_last_cold_cap`` too), a split that rounds to no hot row, FILL pads
and out-of-range ids, the rows each device holds against JAX's
``addressable_shards``, ``sharding()`` against JAX's
``devices_indices_map``, typed stores built by ``Dataset``, and a loader
batch over a grouped store. Then the port's own: the sharded gathers'
plain versions against one table (ids clipped), a group naming one
device twice (each entry its own block), the IPC handle and a pickle
carrying each block, and a pair of cards without peer access refused by
name.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

CPU = 'cpu'
GROUP = 4


def make_feat(n, f=8, seed=0):
  return np.random.default_rng(seed).standard_normal((n, f)).astype(
      np.float32)


def stores(feat, split_ratio):
  """``(port store, JAX store)`` over a group of 4 devices."""
  tg = gtt.data.DeviceGroup(0, [CPU] * GROUP)
  jg = glt.data.DeviceGroup(0, jax.devices()[:GROUP])
  return (gtt.data.Feature(feat, split_ratio=split_ratio,
                           device_group_list=[tg]),
          glt.data.Feature(feat, split_ratio=split_ratio,
                           device_group_list=[jg]))


def hot_ids(n, rng, b=64):
  return rng.integers(0, n, b).astype(np.int32)


@pytest.mark.parametrize('n,split_ratio', [(64, 1.0), (66, 1.0),
                                           (64, 0.5), (66, 0.5),
                                           (66, 0.25)])
def test_grouped_store_rows_equal_jax(n, split_ratio):
  feat = make_feat(n)
  store, jstore = stores(feat, split_ratio)
  rng = np.random.default_rng(n)
  ids = np.concatenate([hot_ids(n, rng), [0, n - 1, -1, -1, n // 2]]
                       ).astype(np.int32)
  np.testing.assert_array_equal(store[ids].numpy(), np.asarray(jstore[ids]))
  ut, jut = store.unified, jstore.unified
  assert ut.shape == tuple(jut.shape)
  assert ut.host_rows == jut.host_rows
  assert ut.sharded
  if ut.host_rows:
    assert ut._last_cold_cap == jut._last_cold_cap
    assert store.device_table() is None and jstore.device_table() is None
  else:
    assert store.device_table() is not None
    assert jstore.device_table() is not None


@pytest.mark.parametrize('n,split_ratio', [(64, 1.0), (66, 1.0),
                                           (64, 0.5), (66, 0.5)])
def test_rows_per_device_equal_jax_shards(n, split_ratio):
  store, jstore = stores(make_feat(n), split_ratio)
  part = store.unified.device_part
  jpart = jstore.unified.device_part
  assert [tuple(s.shape) for s in part.shards] == \
      [tuple(s.data.shape) for s in jpart.addressable_shards]
  r = part.rows_per_shard
  assert [(i * r, (i + 1) * r) for i in range(len(part.shards))] == \
      [(s.index[0].start, s.index[0].stop)
       for s in jpart.addressable_shards]
  assert len(jpart.sharding.device_set) == GROUP


def test_padded_rows_read_as_jax_and_past_them_the_fill():
  """At 66 rows the full split holds 68: ids 66 and 67 read the zero pad
  rows, 68 and beyond the fill (NaN), as JAX's take does."""
  store, jstore = stores(make_feat(66), 1.0)
  ids = np.array([65, 66, 67, 68, 1000, 0], np.int32)
  got = store[ids].numpy()
  np.testing.assert_array_equal(got, np.asarray(jstore[ids]))
  assert (got[1:3] == 0).all() and np.isnan(got[3:5]).all()


def test_a_split_that_rounds_to_no_hot_row_keeps_every_row_on_the_host():
  store, jstore = stores(make_feat(10), 0.2)
  ids = np.array([3, 9, 1, 7, 5], np.int32)
  np.testing.assert_array_equal(store[ids].numpy(), np.asarray(jstore[ids]))
  assert store.unified.device_part is None
  assert store.unified.host_rows == jstore.unified.host_rows == 10


@pytest.mark.parametrize('rows', [64, 68, 4])
def test_sharding_ranges_equal_jax_devices_indices_map(rows):
  tg = gtt.data.DeviceGroup(0, [CPU] * GROUP)
  jg = glt.data.DeviceGroup(0, jax.devices()[:GROUP])
  jmap = jg.sharding().devices_indices_map((rows, 8))
  want = [(jmap[d][0].start, jmap[d][0].stop) for d in jg.device_list]
  assert [(a, b) for _, a, b in tg.sharding().ranges(rows)] == want
  assert tg.sharding().home == torch.device(CPU)


def test_typed_dataset_passes_the_group_to_every_store():
  feats = {'a': make_feat(66, seed=1), 'b': make_feat(40, 4, seed=2)}
  tg = gtt.data.DeviceGroup(0, [CPU] * GROUP)
  jg = glt.data.DeviceGroup(0, jax.devices()[:GROUP])
  tds = gtt.data.Dataset(device=CPU).init_node_features(
      feats, split_ratio=1.0, device_group_list=[tg])
  jds = glt.data.Dataset().init_node_features(
      feats, split_ratio=1.0, device_group_list=[jg])
  for t in feats:
    store, jstore = tds.get_node_feature(t), jds.get_node_feature(t)
    assert store.unified.sharded
    ids = np.arange(feats[t].shape[0], dtype=np.int32)[::-3].copy()
    np.testing.assert_array_equal(store[ids].numpy(),
                                  np.asarray(jstore[ids]))


def test_loader_batch_over_a_grouped_store_equals_one_device():
  """The fused collate gathers through the grouped store's
  ``device_table()`` (its ``ShardedRows``): the batch equals the one over
  the same rows on one device."""
  rng = np.random.default_rng(3)
  n = 66
  ei = rng.integers(0, n, (2, 400))
  feat = make_feat(n)

  def batch(group):
    ds = gtt.data.Dataset(device=CPU)
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feat, device_group_list=group)
    ds.init_node_labels(np.arange(n) % 3)
    loader = gtt.loader.NeighborLoader(ds, [3, 2], np.arange(n),
                                       batch_size=8, device=CPU)
    return next(iter(loader))

  got = batch([gtt.data.DeviceGroup(0, [CPU] * GROUP)])
  want = batch(None)
  assert torch.equal(got.node, want.node)
  assert torch.equal(got.x, want.x)
  assert torch.equal(got.y, want.y)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
def test_sharded_gather_plain_equals_one_table_with_ids_clipped(dtype,
                                                                id_dtype):
  rng = np.random.default_rng(5)
  table = torch.as_tensor(rng.integers(-50, 50, (48, 5))).to(dtype)
  shards = [table[i * 12:(i + 1) * 12].clone() for i in range(4)]
  ids = torch.as_tensor(np.concatenate([rng.integers(0, 48, 40),
                                        [-7, 48, 10 ** 6, 0, 47]])).to(
                                            id_dtype)
  want = ops.gather_rows_plain(table, ids)
  assert torch.equal(ops.gather_rows_sharded_plain(shards, ids), want)
  assert torch.equal(ops.gather_rows_sharded(shards, None, ids), want)
  empty = ids[:0]
  assert ops.gather_rows_sharded(shards, None, empty).shape == (0, 5)


def test_sharded_unified_plain_equals_the_one_block_plain():
  rng = np.random.default_rng(6)
  table = torch.as_tensor(rng.standard_normal((50, 4)).astype(np.float32))
  hot, cold = table[:40], table[40:]
  shards = [hot[i * 10:(i + 1) * 10].clone() for i in range(4)]
  ids = torch.as_tensor(np.concatenate([rng.integers(0, 50, 30), [-1, 99]]))
  rows, cap = ops.gather_rows_unified_sharded_plain(shards, cold, ids)
  want, want_cap = ops.gather_rows_unified_plain(hot, cold, ids)
  assert torch.equal(rows, want) and cap == want_cap
  assert torch.equal(ops.gather_rows_unified_sharded(shards, None, cold,
                                                     ids), want)


@pytest.mark.parametrize('split_ratio', [1.0, 0.5])
def test_group_naming_one_device_twice_holds_a_block_each(split_ratio):
  """A group may name a device more than once (one card then runs the
  sharded layout): each entry holds its own block, and the rows equal a
  plain gather of the whole table."""
  feat = make_feat(30)
  group = gtt.data.DeviceGroup(0, [CPU, CPU])
  store = gtt.data.Feature(feat, split_ratio=split_ratio,
                           device_group_list=[group])
  part = store.unified.device_part
  assert len(part.shards) == 2
  ptrs = [s.untyped_storage().data_ptr() for s in part.shards]
  assert len(set(ptrs)) == 2
  ids = np.array([0, 14, 15, 29, 7, -1, 22], np.int64)
  want = feat[np.maximum(ids, 0)]
  np.testing.assert_array_equal(store[ids].numpy(), want)


def test_grouped_store_ipc_handle_and_pickle_carry_each_block():
  feat = make_feat(66)
  store, _ = stores(feat, 0.5)
  ids = np.array([0, 31, 32, 65, 17], np.int32)
  clone = gtt.data.Feature.from_ipc_handle(store.share_ipc())
  np.testing.assert_array_equal(clone[ids].numpy(), store[ids].numpy())
  np.testing.assert_array_equal(clone.cpu_get(ids), feat[ids])
  again = pickle.loads(pickle.dumps(store))
  part = again.unified.device_part
  assert isinstance(part, type(store.unified.device_part))
  assert len(part.shards) == GROUP
  np.testing.assert_array_equal(again[ids].numpy(), feat[ids])


def test_cards_without_peer_access_are_refused_by_name(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'can_device_access_peer',
                      lambda a, b: False)
  with pytest.raises(RuntimeError, match=r'cuda:0 cannot read the memory '
                     r'of cuda:1'):
    ops.peer.enable(['cuda:0', 'cuda:1', 'cuda:0'])
  # one card named twice, and CPU devices, need no peer access
  ops.peer.enable(['cuda:0', 'cuda:0', 'cpu'])
