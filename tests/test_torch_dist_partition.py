"""The port's distributed partitioner and table ingestion against the
JAX package's, on the CPU.

Mirrors ``tests/test_dist_partition.py``: two ranks (threads over one
output directory, the RPC ``Barrier`` on rank 0) partition their slices
of a homogeneous and of a typed graph with ``DistRandomPartitioner``;
every file the port writes equals the one JAX's partitioner writes from
the same slices, array for array, and the port's ``DistDataset.load``
reads the result onto a two-shard mesh whose batches carry the right
features. ``DistTableDataset`` reads sliced tables, partitions them and
loads them the same way.
"""
import json
import os
import threading

import numpy as np
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.utils import get_free_port

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40


def ring(n=N):
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  return rows, cols


def run_ranks(pkg, out, make_args, world=2):
  """``DistRandomPartitioner`` of ``pkg`` on ``world`` thread ranks."""
  port = get_free_port()
  errors = []

  def run(rank):
    try:
      args, kw = make_args(rank)
      pkg.distributed.DistRandomPartitioner(
          str(out), *args, num_parts=2, rank=rank, world_size=world,
          master_port=port, seed=0, **kw).partition()
    except Exception as e:  # noqa: BLE001 - surfaced below
      errors.append(e)

  ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
  for t in ts:
    t.start()
  for t in ts:
    t.join(120)
    assert not t.is_alive()
  assert not errors, errors


def assert_same_tree(a, b):
  """Every file under ``a`` and ``b``: the same names, JSON equal, and
  every array of every .npy / .npz equal (dtype included)."""
  fa = sorted(os.path.relpath(os.path.join(d, f), a)
              for d, _, fs in os.walk(a) for f in fs)
  fb = sorted(os.path.relpath(os.path.join(d, f), b)
              for d, _, fs in os.walk(b) for f in fs)
  assert fa == fb and fa
  for rel in fa:
    pa, pb = os.path.join(a, rel), os.path.join(b, rel)
    if rel.endswith('.json'):
      assert json.load(open(pa)) == json.load(open(pb)), rel
    elif rel.endswith('.npy'):
      x, y = np.load(pa), np.load(pb)
      assert x.dtype == y.dtype, rel
      np.testing.assert_array_equal(x, y, err_msg=rel)
    else:
      with np.load(pa) as za, np.load(pb) as zb:
        assert sorted(za.files) == sorted(zb.files), rel
        for k in za.files:
          assert za[k].dtype == zb[k].dtype, (rel, k)
          np.testing.assert_array_equal(za[k], zb[k], err_msg=f'{rel}:{k}')


def test_dist_random_partitioner_homo_2ranks(tmp_path):
  rows, cols = ring()
  eids = np.arange(2 * N)
  feat = np.arange(N, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)

  def args(rank):
    sl = slice(rank, None, 2)
    return (N, np.stack([rows[sl], cols[sl]]), eids[sl], feat[rank::2],
            np.arange(N)[rank::2]), {}

  run_ranks(gtt, tmp_path / 'port', args)
  run_ranks(glt, tmp_path / 'jax', args)
  assert_same_tree(tmp_path / 'port', tmp_path / 'jax')
  num_parts, g0, nf0, _, node_pb, edge_pb = \
      gtt.partition.load_partition(str(tmp_path / 'port'), 0)
  _, g1, nf1, _, _, _ = gtt.partition.load_partition(
      str(tmp_path / 'port'), 1)
  assert num_parts == 2
  assert sorted(np.concatenate([g0.eids, g1.eids]).tolist()) == \
      list(range(2 * N))
  assert (node_pb[g0.edge_index[0]] == 0).all()
  assert (edge_pb[g0.eids] == 0).all()
  for p, nf in ((0, nf0), (1, nf1)):
    np.testing.assert_allclose(nf.feats[:, 0], nf.ids)
    assert (node_pb[nf.ids] == p).all()


def test_dist_random_partitioner_hetero_and_load(tmp_path):
  """Two-rank typed partition (files equal JAX's) -> the port's
  ``DistDataset.load`` -> a two-shard batch with typed features."""
  et1, et2 = ('u', 'to', 'v'), ('v', 'back', 'u')
  r = np.arange(N)
  c1, c2 = (r + 1) % N, (r + 2) % N
  nfeat = {'u': np.arange(N, dtype=np.float32)[:, None] *
           np.ones((1, 4), np.float32),
           'v': 1000.0 + np.arange(N, dtype=np.float32)[:, None] *
           np.ones((1, 4), np.float32)}

  def args(rank):
    sl = slice(rank, None, 2)
    return ({'u': N, 'v': N},
            {et1: np.stack([r[sl], c1[sl]]), et2: np.stack([r[sl], c2[sl]])},
            {et1: r[sl], et2: r[sl]},
            {t: f[rank::2] for t, f in nfeat.items()},
            {t: r[rank::2] for t in nfeat}), {}

  run_ranks(gtt, tmp_path / 'port', args)
  run_ranks(glt, tmp_path / 'jax', args)
  assert_same_tree(tmp_path / 'port', tmp_path / 'jax')
  mesh = gtt.distributed.ShardMesh(2, 'cpu')
  ds = gtt.distributed.DistDataset().load(str(tmp_path / 'port'), mesh=mesh)
  assert ds.graph.is_hetero and set(ds.graph.etypes) == {et1, et2}
  loader = gtt.distributed.DistNeighborLoader(
      ds, {et1: [2], et2: [1]}, ('u', np.arange(N)), batch_size=4, seed=0,
      mesh=mesh)
  batch = next(iter(loader))
  for t, base in (('u', 0.0), ('v', 1000.0)):
    node, x = batch.node[t].numpy(), batch.x[t].numpy()
    for p in range(2):
      nn = int(np.asarray(batch.num_nodes[t])[p])
      np.testing.assert_allclose(x[p, :nn, 0], base + node[p, :nn])


def test_dist_table_dataset_end_to_end(tmp_path):
  """Tables -> sliced read -> partition (files equal JAX's) -> a
  two-shard load -> a batch with features and labels."""
  rows, cols = ring()
  np.save(tmp_path / 'edges.npy',
          np.stack([rows, cols, np.arange(2 * N)]).T)
  feat = np.arange(N, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)
  np.savez(tmp_path / 'nodes.npz', ids=np.arange(N), feats=feat,
           labels=np.arange(N) % 3)
  mesh = gtt.distributed.ShardMesh(2, 'cpu')
  ds = gtt.distributed.DistTableDataset().load_tables(
      str(tmp_path / 'edges.npy'), str(tmp_path / 'nodes.npz'),
      num_nodes=N, num_partitions=2, partition_idx=0, world_size=1,
      output_dir=str(tmp_path / 'port'), mesh=mesh)
  # JAX's partitioner on the same one-rank read
  from graphlearn_tpu.distributed import dist_table_dataset as jtd
  r, c, e = jtd._read_edge_table(str(tmp_path / 'edges.npy'), 0, 1)
  ids, feats, _ = jtd._read_node_table(str(tmp_path / 'nodes.npz'), 0, 1)
  glt.distributed.DistRandomPartitioner(
      str(tmp_path / 'jax'), N, np.stack([r, c]), e, feats, ids,
      num_parts=2, rank=0, world_size=1, seed=0).partition()
  assert_same_tree(tmp_path / 'port', tmp_path / 'jax')
  assert ds.num_partitions == 2
  np.testing.assert_array_equal(ds.node_labels, np.arange(N) % 3)
  loader = gtt.distributed.DistNeighborLoader(
      ds, [2], np.arange(N), batch_size=4, seed=0, mesh=mesh)
  batch = next(iter(loader))
  node, x, y = batch.node.numpy(), batch.x.numpy(), batch.y.numpy()
  for p in range(2):
    nn = int(np.asarray(batch.num_nodes)[p])
    np.testing.assert_allclose(x[p, :nn, 0], node[p, :nn])
    np.testing.assert_array_equal(y[p, :nn], node[p, :nn] % 3)
