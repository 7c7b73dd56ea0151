"""Distributed supervised GraphSAGE over P graph shards, on the port.

Counterpart of ``examples/distributed/dist_train_sage_supervised.py``:
the JAX example's community graph, draw for draw (``make_graph``: labels
are communities, 85% of the edges stay inside one), partitioned into P
shards by ``node_pb`` (``v % P`` there and by default here;
``partition_in_memory`` takes any book, e.g. ``RandomPartitioner``'s),
then a tree-mode ``DistNeighborLoader`` and a data-parallel GraphSAGE
step (the package's ``DistFusedEpochTrainer`` step): each shard computes
its own loss on its own batch, the gradients are averaged over the
shards (JAX: ``lax.pmean`` over ``'g'``), and one Adam step follows. On a one-process mesh that is the gradient of the
mean loss; under a process group (``init_multihost``) each rank's
gradient is summed by ``all_reduce`` after the backward of its loss over
P. One JSON line: the first and final loss, the final train accuracy and
the mean epoch time.

``--num-partitions`` defaults to JAX's rule, one partition per device.
On a machine with several cards (``--device`` not given) the example runs
one rank per card, torch's counterpart of JAX's one-process mesh over
several chips: ``torch.multiprocessing`` spawns the ranks, each joins an
NCCL group (``init_multihost`` on ``localhost``) and holds one shard, and
rank 0 prints the line. With one card, or a named ``--device``, one
process holds every partition on that device (one unless more are asked
for).

Run on the card(s): python -m graphlearn_tpu_torch.examples.dist_train_sage_supervised
On the CPU:         ... --device cpu --num-nodes 4000 --num-partitions 4
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

NUM_CLASSES = 16
FEAT_DIM = 64


def make_graph(n: int, avg_deg: int, ncls: int, rng, feat_dim=FEAT_DIM):
  """The JAX example's community graph: ``(edge_index [2, n * avg_deg]
  int32, feats [n, feat_dim] float32, labels [n] int32)``."""
  comm = rng.integers(0, ncls, n).astype(np.int32)
  order = np.argsort(comm, kind='stable').astype(np.int32)
  counts = np.bincount(comm, minlength=ncls)
  offsets = np.zeros(ncls + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  e = n * avg_deg
  rows = rng.integers(0, n, e).astype(np.int32)
  intra = rng.random(e) < 0.85
  cols = np.empty(e, np.int32)
  rc = comm[rows[intra]]
  u = rng.random(intra.sum())
  cols[intra] = order[offsets[rc] + (u * counts[rc]).astype(np.int64)]
  cols[~intra] = rng.integers(0, n, (~intra).sum())
  feat = rng.standard_normal((n, feat_dim)).astype(np.float32)
  return np.stack([rows, cols]), feat, comm


def partition_in_memory(edge_index, feats, node_pb, num_parts: int):
  """``(parts, feat_parts)``: each partition's edges (by source, with
  their global ids) and its owned ids' feature rows, as the
  partitioners write them."""
  from graphlearn_tpu_torch.typing import GraphPartitionData
  rows, cols = edge_index
  eids = np.arange(rows.shape[0])
  epb = node_pb[rows]
  parts, feat_parts = [], []
  for p in range(num_parts):
    m = epb == p
    parts.append(GraphPartitionData(edge_index=np.stack([rows[m], cols[m]]),
                                    eids=eids[m]))
    ids = np.nonzero(node_pb == p)[0]
    feat_parts.append((ids.astype(np.int64), feats[ids]))
  return parts, feat_parts


def build_dataset(edge_index, feats, labels, node_pb, mesh, **feature_kw):
  """A ``DistDataset`` of the in-memory partitions on ``mesh``."""
  from graphlearn_tpu_torch import distributed as gdist
  nparts = mesh.num_partitions
  parts, feat_parts = partition_in_memory(edge_index, feats, node_pb,
                                          nparts)
  dg = gdist.DistGraph(nparts, 0, parts, node_pb)
  df = gdist.DistFeature(nparts, feat_parts, node_pb, mesh, **feature_kw)
  return gdist.DistDataset(nparts, 0, dg, df,
                           node_labels=np.asarray(labels, np.int64))


def make_model(in_dim: int, hidden: int, ncls: int, fanouts, batch_size,
               device, generator=None):
  """The tree-dense layered GraphSAGE of the example's batches."""
  from graphlearn_tpu_torch.models import GraphSAGE, tree_hop_offsets
  no, eo = tree_hop_offsets(batch_size, fanouts)
  return GraphSAGE(in_dim, hidden, ncls, num_layers=len(fanouts),
                   hop_node_offsets=no, hop_edge_offsets=eo,
                   tree_dense=True, fanouts=tuple(fanouts), device=device,
                   generator=generator)


def dp_step(model, optimizer, batch, mesh, ncls: int = NUM_CLASSES):
  """One data-parallel step over the batch's local shards
  (``loader.pipeline.data_parallel_step``, the step of
  ``DistFusedEpochTrainer``): each shard's masked seed cross-entropy
  (the JAX example's ``loss_fn``), the backward of their sum over P, the
  gradients summed over the process group (if any), one optimizer step.
  Returns the mean loss and accuracy over all P shards (0-d tensors)."""
  from graphlearn_tpu_torch.loader.pipeline import (data_parallel_step,
                                                    shard_batches)
  from graphlearn_tpu_torch.models.train import make_loss_fn
  stacked = dict(x=batch.x, edge_index=batch.edge_index,
                 edge_mask=batch.edge_mask, y=batch.y,
                 num_seed_nodes=batch.num_sampled_nodes[:, 0])
  return data_parallel_step(optimizer, make_loss_fn(model, ncls),
                            shard_batches(stacked), mesh)


def train(args, ctx):
  """The example's epochs on the context's mesh: ``(first loss, final
  loss, final accuracy, mean epoch s)``."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.models import create_train_state
  mesh = ctx.mesh
  nparts = ctx.num_partitions
  rng = np.random.default_rng(0)
  ei, feat, labels = make_graph(args.num_nodes, args.avg_deg, NUM_CLASSES,
                                rng)
  node_pb = (np.arange(args.num_nodes) % nparts).astype(np.int32)
  ds = build_dataset(ei, feat, labels, node_pb, mesh)
  loader = gdist.DistNeighborLoader(
      ds, list(args.fanout), np.arange(args.num_nodes),
      batch_size=args.batch_size, shuffle=True, drop_last=True, seed=0,
      mesh=mesh, dedup='tree')
  model = make_model(FEAT_DIM, args.hidden, NUM_CLASSES, args.fanout,
                     args.batch_size, mesh.device,
                     torch.Generator().manual_seed(0))
  state = create_train_state(model, lr=args.lr)
  losses, accs, epoch_times = [], [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      loss, acc = dp_step(model, state.optimizer, batch, mesh)
      losses.append(loss)
      accs.append(acc)
    if mesh.device.type == 'cuda':
      torch.cuda.synchronize(mesh.device)
    epoch_times.append(time.perf_counter() - t0)
  return (float(losses[0]), float(losses[-1]), float(accs[-1]),
          float(np.mean(epoch_times)))


def report(nparts: int, ranks: int, result):
  first, final, acc, epoch_s = result
  print(json.dumps({
      'mesh_size': nparts,
      'ranks': ranks,
      'first_loss': round(first, 4),
      'final_loss': round(final, 4),
      'final_train_acc': round(acc, 4),
      'epoch_time_s': round(epoch_s, 3),
  }), flush=True)


def rank_main(rank: int, world: int, port: int, devices, argv):
  """One rank of the several-card run: joins the group of ``world`` ranks
  on ``devices[rank]`` (NCCL on a card, gloo on the CPU), trains its
  shard; rank 0 prints the line."""
  import torch.distributed as dist
  from graphlearn_tpu_torch import distributed as gdist
  args = parse_args(argv)
  ctx = gdist.init_multihost(f'localhost:{port}', world, rank,
                             num_partitions=world, device=devices[rank])
  try:
    result = train(args, ctx)
  finally:
    dist.destroy_process_group()
  if rank == 0:
    report(world, world, result)


def run_ranks(argv, devices) -> None:
  """Spawn one rank per entry of ``devices`` (``rank_main``) and wait for
  them; raises if one fails."""
  import torch.multiprocessing as tmp
  from graphlearn_tpu_torch.utils import get_free_port
  tmp.spawn(rank_main, args=(len(devices), get_free_port(), list(devices),
                             list(argv)), nprocs=len(devices), join=True)


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--num-nodes', type=int, default=20_000)
  ap.add_argument('--avg-deg', type=int, default=12)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--fanout', type=int, nargs='+', default=[10, 5])
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--num-partitions', type=int, default=None,
                  help='graph shards (default: one per device: the cards, '
                  'or 1 on a named --device)')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the cards, one rank each "
                  "when there are several); 'cpu' to run on the CPU")
  return ap.parse_args(argv)


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  args = parse_args(argv)
  from graphlearn_tpu_torch import distributed as gdist
  cards = (torch.cuda.device_count()
           if args.device is None and torch.cuda.is_available() else 0)
  if cards > 1:
    nparts = args.num_partitions or cards
    if nparts > cards:
      raise SystemExit(f'--num-partitions {nparts} on {cards} cards: one '
                       'rank holds one shard on its card; name a --device '
                       'to stack partitions on one card')
    run_ranks(argv, [f'cuda:{r}' for r in range(nparts)])
    return
  ctx = gdist.init_worker_group(num_partitions=args.num_partitions or 1,
                                devices=args.device)
  report(ctx.num_partitions, 1, train(args, ctx))


if __name__ == '__main__':
  main()
