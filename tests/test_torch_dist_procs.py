"""The process-group mesh: two gloo processes, one shard each.

``distributed.init_multihost`` on the CPU (gloo) with two processes
spawned once for the module, each on a rendezvous port from
``utils.get_free_port``. Each rank holds one shard of the P = 2 ring of
``tests/test_distributed.py``; its ``DistFeature.get`` and its
``sample_from_nodes`` batches (tree and merge, ``bucket_frac`` 2.0 and
None, with edge ids) equal, exactly, the one-process ``ShardMesh``
result for that shard, and one data-parallel step of the example (the
gradients summed by ``all_reduce``) leaves the same parameters and loss
as the one-process step, and an eager ``DistScanTrainer`` epoch equals
the one-process epoch (on the CPU ``capture=True`` is refused: a CUDA
graph needs a card; under NCCL the chunk is captured). So do
a link batch (shard-local negatives), a typed batch of the two-type
ring, a subgraph batch (the ``all_gather`` of the node keys) and node
batches on the 2-axis layouts (2, 1) and (1, 2) (subgroups per slice and
per chip column). The one-process side is held against JAX's shard_map
programs in ``tests/test_torch_distributed.py``,
``tests/test_torch_dist_scan.py``, ``tests/test_torch_dist_link.py``,
``tests/test_torch_dist_hetero.py``, ``tests/test_torch_dist_subgraph.py``
and ``tests/test_torch_dist_hier.py``.
"""
import multiprocessing as mp
import os
import tempfile

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import distributed as gdist
from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
from graphlearn_tpu_torch.typing import GraphPartitionData

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40
P = 2
MODES = [('tree', 2.0), ('tree', None), ('merge', 2.0), ('merge', None)]
FIELDS = ('node', 'num_nodes', 'row', 'col', 'edge_mask', 'edge',
          'num_sampled_nodes', 'num_sampled_edges', 'overflow')
TOL = dict(rtol=1e-4, atol=1e-5)


def ring(num_parts=P):
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  eids = np.arange(2 * N)
  node_pb = (np.arange(N) % num_parts).astype(np.int32)
  edge_pb = node_pb[rows]
  parts, feats = [], []
  for p in range(num_parts):
    m = edge_pb == p
    parts.append(GraphPartitionData(edge_index=np.stack([rows[m], cols[m]]),
                                    eids=eids[m]))
    ids = np.nonzero(node_pb == p)[0]
    feats.append((ids.astype(np.int64),
                  ids[:, None].astype(np.float32) * np.ones((1, 4),
                                                            np.float32)))
  return parts, feats, node_pb, edge_pb


def _ids():
  return np.random.default_rng(5).integers(-1, N, (P, 12)).astype(np.int32)


def _seeds():
  return np.random.default_rng(6).permutation(N)[:P * 4].reshape(P, 4)


def run_all(mesh):
  """Every result this file compares, on ``mesh``: a dict of CPU
  tensors (each ``[L, ...]``)."""
  parts, feats, node_pb, edge_pb = ring()
  out = {}
  df = gdist.DistFeature(P, feats, node_pb, mesh, bucket_frac=1.0)
  out['feat'] = df.get(_ids())
  out['feat_stats'] = torch.as_tensor(
      [df.stats()[k] for k in ('hits', 'misses', 'unique_misses',
                               'overflow')])
  dg = gdist.DistGraph(P, 0, parts, node_pb, edge_pb)
  for dedup, frac in MODES:
    s = gdist.DistNeighborSampler(dg, [2, 2], mesh, with_edge=True, seed=1,
                                  dedup=dedup, bucket_frac=frac)
    for it in range(2):
      o = s.sample_from_nodes(_seeds())
      for f in FIELDS:
        v = getattr(o, f, None)
        out[f'{dedup}/{frac}/{it}/{f}'] = (o.metadata['overflow']
                                           if f == 'overflow' else v)
  # one data-parallel step of the example on a community graph
  rng = np.random.default_rng(0)
  ei, x, labels = ex.make_graph(400, 6, ex.NUM_CLASSES, rng, feat_dim=8)
  pb = (np.arange(400) % P).astype(np.int32)
  ds = ex.build_dataset(ei, x, labels, pb, mesh)
  loader = gdist.DistNeighborLoader(ds, [3, 2], np.arange(400),
                                    batch_size=8, shuffle=True, seed=0,
                                    mesh=mesh, dedup='tree')
  model = ex.make_model(8, 16, ex.NUM_CLASSES, [3, 2], 8, mesh.device,
                        torch.Generator().manual_seed(0))
  state = gtt.models.create_train_state(model, lr=3e-3)
  batch = next(iter(loader))
  out['x'] = batch.x
  loss, acc = ex.dp_step(model, state.optimizer, batch, mesh)
  out['loss'] = loss.detach()
  out['acc'] = acc.detach()
  for name, p in model.state_dict().items():
    out[f'param/{name}'] = p.detach().clone()
  out.update(scan_epoch(mesh, parts, feats, node_pb, edge_pb))
  out.update(more_paths(mesh, parts, node_pb, edge_pb))
  return {k: v.cpu() for k, v in out.items() if v is not None}


def hetero_ring():
  """The two-type ring of ``tests/test_distributed.py``."""
  et1, et2 = ('u', 'to', 'v'), ('v', 'back', 'u')
  ui = np.arange(N)
  e1 = np.stack([np.concatenate([ui, ui]),
                 np.concatenate([ui, (ui + 1) % N])])
  e2 = np.stack([ui, (ui + 2) % N])
  pb = {'u': (ui % P).astype(np.int32), 'v': ((ui + 1) % P).astype(np.int32)}
  parts = []
  for p in range(P):
    m1, m2 = pb['u'][e1[0]] == p, pb['v'][e2[0]] == p
    parts.append({et1: GraphPartitionData(edge_index=e1[:, m1],
                                          eids=np.nonzero(m1)[0]),
                  et2: GraphPartitionData(edge_index=e2[:, m2],
                                          eids=np.nonzero(m2)[0])})
  return parts, pb, {et1: [2, 1], et2: [1, 1]}


def more_paths(mesh, parts, node_pb, edge_pb):
  """A link, a typed, a subgraph and two 2-axis node batches."""
  from graphlearn_tpu_torch.sampler import EdgeSamplerInput, NegativeSampling
  out = {}
  dg = gdist.DistGraph(P, 0, parts, node_pb, edge_pb)
  rows = (np.arange(8) * 3 % N).reshape(P, 4)
  for mode in ('binary', 'triplet'):
    s = gdist.DistNeighborSampler(dg, [2, 2], mesh, seed=3, bucket_frac=None,
                                  neg_strict=True)
    o = s.sample_from_edges(EdgeSamplerInput(
        rows, (rows + 1) % N, neg_sampling=NegativeSampling(mode, 2)))
    for f in ('node', 'row', 'col', 'edge_mask'):
      out[f'link/{mode}/{f}'] = getattr(o, f)
    for k in ('edge_label_index', 'dst_neg_index', 'seed_mask'):
      if k in o.metadata:
        out[f'link/{mode}/{k}'] = o.metadata[k]
  hparts, hpb, fan = hetero_ring()
  hg = gdist.DistHeteroGraph(P, 0, hparts, hpb)
  for dedup in ('tree', 'merge'):
    s = gdist.DistNeighborSampler(hg, fan, mesh, seed=4, dedup=dedup,
                                  with_edge=True)
    o = s.sample_from_nodes(('u', _seeds()))
    for f in ('node', 'row', 'col', 'edge_mask', 'edge'):
      for k, v in getattr(o, f).items():
        out[f'typed/{dedup}/{f}/{k}'] = v
  s = gdist.DistNeighborSampler(dg, [2], mesh, seed=5, with_edge=True)
  o = s.subgraph(_seeds())
  for f in ('node', 'row', 'col', 'edge_mask', 'edge'):
    out[f'sub/{f}'] = getattr(o, f)
  out['sub/mapping'] = o.metadata['mapping']
  for shape in ((2, 1), (1, 2)):
    hmesh = gdist.ShardMesh(P, mesh.device, group=mesh.group, shape=shape)
    s = gdist.DistNeighborSampler(dg, [2, 2], hmesh, seed=6, bucket_frac=0.5)
    o = s.sample_from_nodes(_seeds())
    for f in ('node', 'row', 'col', 'edge_mask'):
      out[f'hier/{shape}/{f}'] = getattr(o, f)
  return out


def scan_epoch(mesh, parts, feats, node_pb, edge_pb):
  """An eager ``DistScanTrainer`` epoch over the ring (5 steps, chunks of
  2, the last step ragged): its losses and parameters; under a process
  group, whether ``capture=True`` is refused there (gloo on the CPU: a
  CUDA graph needs a card), and whether ``local_rows`` takes the rank's
  row as a view (no index upload inside a capture)."""
  out = {}
  df = gdist.DistFeature(P, feats, node_pb, mesh, split_ratio=0.25,
                         bucket_frac=None)
  ds = gdist.DistDataset(P, 0, gdist.DistGraph(P, 0, parts, node_pb,
                                               edge_pb), df,
                         node_labels=np.arange(N) % 3)
  loader = gdist.DistNeighborLoader(ds, [2, 2], np.arange(18), batch_size=2,
                                    shuffle=True, drop_last=False, seed=0,
                                    mesh=mesh, bucket_frac=None)
  model = gtt.models.GraphSAGE(4, 8, 3, num_layers=2, device='cpu',
                               generator=torch.Generator().manual_seed(0))
  if mesh.group is not None:
    try:
      gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=2,
                                 capture=True)
      out['cpu_capture_refused'] = torch.tensor(False)
    except ValueError as e:
      out['cpu_capture_refused'] = torch.tensor('CUDA device' in str(e))
    rows = torch.arange(P * 3).reshape(P, 3)
    mine = mesh.local_rows(rows)
    out['local_rows_view'] = torch.tensor(
        mine.untyped_storage().data_ptr() ==
        rows.untyped_storage().data_ptr() and
        mine.data_ptr() == rows[mesh.local_shards[0]].data_ptr() and
        torch.equal(mine, rows[mesh.local_shards]))
  trainer = gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=2)
  state = gtt.models.create_train_state(model, lr=1e-2)
  state, losses, _ = trainer.run_epoch(state)
  out['scan/losses'] = losses
  for name, p in model.state_dict().items():
    out[f'scan/param/{name}'] = p.detach().clone()
  return out


def _rank_main(rank, port, outdir):
  import torch.distributed as dist
  torch.set_num_threads(1)
  ctx = gdist.init_multihost(f'localhost:{port}', P, rank, device='cpu')
  try:
    res = run_all(ctx.mesh)
    torch.save(res, os.path.join(outdir, f'rank{rank}.pt'))
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks():
  """Each rank's results from one spawn of two gloo processes."""
  port = gtt.utils.get_free_port()
  with tempfile.TemporaryDirectory() as outdir:
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_rank_main, args=(r, port, outdir))
             for r in range(P)]
    for proc in procs:
      proc.start()
    for proc in procs:
      proc.join(120)
    for proc in procs:
      if proc.is_alive():
        proc.kill()
    assert all(proc.exitcode == 0 for proc in procs), \
        [proc.exitcode for proc in procs]
    return [torch.load(os.path.join(outdir, f'rank{r}.pt'))
            for r in range(P)]


@pytest.fixture(scope='module')
def whole():
  return run_all(gdist.ShardMesh(P, 'cpu'))


def test_process_mesh_holds_one_shard_per_rank(ranks):
  for r, res in enumerate(ranks):
    assert res['feat'].shape[0] == 1
    assert res['tree/2.0/0/node'].shape[0] == 1


def test_feature_get_per_rank_equals_one_process(ranks, whole):
  for r, res in enumerate(ranks):
    assert torch.equal(res['feat'][0], whole['feat'][r])
  # the counters are each process's own shard rows: their sum is the
  # one-process total
  assert torch.equal(ranks[0]['feat_stats'] + ranks[1]['feat_stats'],
                     whole['feat_stats'])


@pytest.mark.parametrize('dedup,frac', MODES)
def test_sample_per_rank_equals_one_process(ranks, whole, dedup, frac):
  for r, res in enumerate(ranks):
    for it in range(2):
      for f in FIELDS:
        key = f'{dedup}/{frac}/{it}/{f}'
        assert torch.equal(res[key][0], whole[key][r]), key


def test_dp_step_all_reduce_equals_one_process(ranks, whole):
  for r, res in enumerate(ranks):
    assert torch.equal(res['x'][0], whole['x'][r])
    torch.testing.assert_close(res['loss'], whole['loss'], **TOL)
    torch.testing.assert_close(res['acc'], whole['acc'], **TOL)
    for k, v in whole.items():
      if k.startswith('param/'):
        torch.testing.assert_close(res[k], v, **TOL, msg=k)


def test_scanned_epoch_on_the_group_equals_one_process(ranks, whole):
  """One shard per rank, the gradients summed by ``all_reduce``: the
  eager scanned epoch equals the one-process mesh's; on the CPU (gloo)
  ``capture=True`` is refused by its CPU rule (a CUDA graph needs a
  card; under NCCL it captures), and a rank's rows are a view."""
  assert whole['scan/losses'].shape == (5,)
  for res in ranks:
    assert bool(res['cpu_capture_refused'])
    assert bool(res['local_rows_view'])
    torch.testing.assert_close(res['scan/losses'], whole['scan/losses'],
                               **TOL)
    for k, v in whole.items():
      if k.startswith('scan/param/'):
        torch.testing.assert_close(res[k], v, **TOL, msg=k)


def test_link_typed_subgraph_and_hier_per_rank_equal_one_process(ranks,
                                                                 whole):
  keys = [k for k in whole if k.split('/')[0] in ('link', 'typed', 'sub',
                                                  'hier')]
  assert any(k.startswith('typed/merge/') for k in keys)
  assert any(k.startswith('hier/(1, 2)/') for k in keys)
  for r, res in enumerate(ranks):
    assert set(keys) <= set(res)
    for k in keys:
      assert torch.equal(res[k][0], whole[k][r]), k


def test_example_one_rank_per_device_equals_one_process(capfd):
  """The example's several-device route (one spawned rank per device,
  ``init_multihost``; gloo here, NCCL on cards) trains the same P = 2
  shards as one process holding both: the same line, but for ``ranks``."""
  import json
  argv = ['--num-nodes', '400', '--epochs', '1', '--batch-size', '16',
          '--hidden', '8', '--fanout', '3', '2']
  ex.run_ranks(argv, ['cpu', 'cpu'])
  ranks = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
  ex.main(argv + ['--device', 'cpu', '--num-partitions', '2'])
  whole = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
  assert ranks['mesh_size'] == whole['mesh_size'] == 2
  assert ranks['ranks'] == 2 and whole['ranks'] == 1
  for k in ('first_loss', 'final_loss', 'final_train_acc'):
    assert abs(ranks[k] - whole[k]) <= 2e-4, (k, ranks[k], whole[k])
