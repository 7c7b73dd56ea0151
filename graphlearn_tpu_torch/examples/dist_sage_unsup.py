"""Distributed unsupervised GraphSAGE (link prediction over P graph
shards), on the port.

Counterpart of ``examples/distributed/dist_sage_unsup.py``: the JAX
example's community graph, draw for draw (``make_data``: 16 communities
as residue classes, 85% of the edges inside one, one-hot-ish 64-wide
features, a 90/10 link split made before partitioning so test edges stay
out of the message-passing graph), partitioned into P shards by ``v %
P``. A ``DistLinkNeighborLoader`` draws per-shard link batches with one
binary negative per positive (shard-local negatives), and the
data-parallel step of the package (``loader.pipeline.
data_parallel_step``: each shard's loss on its own batch, the gradients
averaged over the shards, one Adam step) trains a segment GraphSAGE
with BCE on dot-product edge scores. Evaluation counts the test links
whose score sign matches the label over all shards. One JSON line: the
first and final loss, the final train accuracy, the test link accuracy
and the mean epoch time.

Run on the card:   python -m graphlearn_tpu_torch.examples.dist_sage_unsup
On the CPU:        ... --device cpu --num-nodes 2000 --num-partitions 2
"""
import argparse
import json
import time

import numpy as np
import torch

NCOMM = 16
FEAT_DIM = 64


def make_data(n: int, avg_deg: int, rng):
  """The JAX example's graph and split: ``(train_eli [2, 0.9 e], test_eli
  [2, 0.1 e], feats [n, 64] float32)``, ``e = n * avg_deg``."""
  comm = (np.arange(n) % NCOMM).astype(np.int32)
  e = n * avg_deg
  rows = rng.integers(0, n, e).astype(np.int32)
  intra = rng.random(e) < 0.85
  cols = np.where(intra,
                  (rows + NCOMM * rng.integers(0, n // NCOMM, e)) % n,
                  rng.integers(0, n, e)).astype(np.int32)
  feat = (comm[:, None] == np.arange(FEAT_DIM) % NCOMM).astype(np.float32) + \
      0.3 * rng.standard_normal((n, FEAT_DIM)).astype(np.float32)
  perm = rng.permutation(e)
  tr_idx, te_idx = perm[: int(e * 0.9)], perm[int(e * 0.9):]
  eli = np.stack([rows, cols])
  return eli[:, tr_idx], eli[:, te_idx], feat


def build_dataset(train_eli, feat, mesh):
  """A ``DistDataset`` of the training edges (by source, ids their
  position in ``train_eli``) and the features, on ``mesh``: node ``v``
  on partition ``v % P``."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.typing import GraphPartitionData
  nparts = mesh.num_partitions
  n = feat.shape[0]
  node_pb = (np.arange(n) % nparts).astype(np.int32)
  g_rows, g_cols = train_eli
  epb = node_pb[g_rows]
  parts, feats = [], []
  for p in range(nparts):
    m = epb == p
    parts.append(GraphPartitionData(
        edge_index=np.stack([g_rows[m], g_cols[m]]), eids=np.nonzero(m)[0]))
    ids = np.nonzero(node_pb == p)[0]
    feats.append((ids.astype(np.int64), feat[ids]))
  dg = gdist.DistGraph(nparts, 0, parts, node_pb)
  df = gdist.DistFeature(nparts, feats, node_pb, mesh)
  return gdist.DistDataset(nparts, 0, dg, df)


def scores(model, batch):
  """One shard's edge scores ``[M]`` (dot products of the endpoint
  embeddings, float32) and their validity."""
  h = model(batch['x'], batch['edge_index'], batch['edge_mask']).float()
  eli = batch['eli']
  valid = (eli[0] >= 0) & (eli[1] >= 0)
  s = (h[eli[0].clamp(min=0)] * h[eli[1].clamp(min=0)]).sum(-1)
  return s, valid


def loss_fn_for(model):
  """``batch -> (loss, acc)`` of one shard: masked mean BCE of the
  scores against ``edge_label`` and the share of valid pairs whose score
  sign matches the label (the JAX example's ``loss_fn``)."""
  import torch.nn.functional as F

  def loss_fn(batch):
    s, valid = scores(model, batch)
    lab = batch['label'].float()
    bce = -lab * F.logsigmoid(s) - (1.0 - lab) * F.logsigmoid(-s)
    denom = torch.clamp(valid.sum(), min=1).float()
    loss = torch.where(valid, bce, 0.0).sum() / denom
    hit = ((s > 0) == (lab > 0.5)) & valid
    return loss, hit.sum().float() / denom

  return loss_fn


def fields(batch) -> dict:
  """The stacked ``[L, ...]`` step inputs of a link batch."""
  return dict(x=batch.x, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask,
              eli=batch.metadata['edge_label_index'],
              label=batch.metadata['edge_label'])


def make_step(model, mesh):
  """``step(state, batch) -> (state, loss, acc)``: the package's
  data-parallel step over the batch's local shards."""
  from graphlearn_tpu_torch.loader.pipeline import (data_parallel_step,
                                                    shard_batches)
  loss_fn = loss_fn_for(model)

  def step(state, batch):
    loss, acc = data_parallel_step(state.optimizer, loss_fn,
                                   shard_batches(fields(batch)), mesh)
    return state._replace(step=state.step + 1), loss, acc

  return step


@torch.no_grad()
def eval_counts(model, batch, mesh):
  """``(hits, valid)`` of a test batch summed over all P shards."""
  from graphlearn_tpu_torch.loader.pipeline import shard_batches
  hits = valid = 0
  for b in shard_batches(fields(batch)):
    s, v = scores(model, b)
    hits = hits + (((s > 0) == (b['label'] > 0)) & v).sum()
    valid = valid + v.sum()
  both = torch.stack([torch.as_tensor(hits), torch.as_tensor(valid)])
  if mesh.group is not None:
    import torch.distributed as dist
    dist.all_reduce(both, group=mesh.group)
  return both


def parser():
  ap = argparse.ArgumentParser()
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--num-nodes', type=int, default=20_000)
  ap.add_argument('--avg-deg', type=int, default=12)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--fanout', type=int, nargs='+', default=[10, 5])
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--num-partitions', type=int, default=4)
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card); 'cpu' to run on "
                  'the CPU')
  return ap


def run(args, params=None):
  """The example; ``params``: a flax parameter tree to start from (the
  JAX example's initial parameters). Returns ``(result dict, model)``."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.models import GraphSAGE, convert
  from graphlearn_tpu_torch.models import create_train_state
  from graphlearn_tpu_torch.sampler import NegativeSampling
  ctx = gdist.init_worker_group(num_partitions=args.num_partitions,
                                devices=args.device)
  mesh = ctx.mesh
  rng = np.random.default_rng(0)
  train_eli, test_eli, feat = make_data(args.num_nodes, args.avg_deg, rng)
  ds = build_dataset(train_eli, feat, mesh)
  loader = gdist.DistLinkNeighborLoader(
      ds, list(args.fanout), train_eli, batch_size=args.batch_size,
      shuffle=True, neg_sampling=NegativeSampling('binary', 1), mesh=mesh,
      seed=0)
  test_loader = gdist.DistLinkNeighborLoader(
      ds, list(args.fanout), test_eli, batch_size=args.batch_size,
      shuffle=False, neg_sampling=NegativeSampling('binary', 1), mesh=mesh,
      seed=1)
  model = GraphSAGE(FEAT_DIM, args.hidden, args.hidden,
                    num_layers=len(args.fanout), device=mesh.device,
                    generator=torch.Generator().manual_seed(0))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model))
  # the JAX example draws one batch to initialize its parameters
  next(iter(loader))
  state = create_train_state(model, lr=args.lr)
  step = make_step(model, mesh)
  losses, accs, epoch_times = [], [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, acc = step(state, batch)
      losses.append(loss)
      accs.append(acc)
    if mesh.device.type == 'cuda':
      torch.cuda.synchronize(mesh.device)
    epoch_times.append(time.perf_counter() - t0)
  total = torch.zeros(2, dtype=torch.int64, device=mesh.device)
  for batch in test_loader:
    total = total + eval_counts(model, batch, mesh)
  hits, valid = (int(v) for v in total.cpu())
  result = {
      'model': 'dist-SAGE-unsup', 'mesh_size': ctx.num_partitions,
      'first_loss': round(float(losses[0]), 4),
      'final_loss': round(float(losses[-1]), 4),
      'final_train_acc': round(float(accs[-1]), 4),
      'test_link_acc': round(hits / max(valid, 1), 4),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
  }
  return result, model


def main(argv=None):
  result, _ = run(parser().parse_args(argv))
  print(json.dumps(result), flush=True)


if __name__ == '__main__':
  main()
