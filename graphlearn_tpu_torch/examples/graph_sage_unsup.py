"""Unsupervised GraphSAGE by link prediction, on the port.

Counterpart of ``examples/graph_sage_unsup.py``: a ``LinkNeighborLoader``
draws positive edges and binary negatives per batch (the negatives in one
kernel launch on the card), GraphSAGE embeds the sampled subgraph, and the
loss is sigmoid binary cross-entropy of the dot-product scores of the
``edge_label_index`` pairs. The graph is the JAX example's synthetic
community graph, built from the same numpy stream: 32 communities, 90% of
the edges inside one, features with a weak community signal; 10% of the
canonical undirected pairs are held out of the graph and the training
pairs.

Run on the card:   python -m graphlearn_tpu_torch.examples.graph_sage_unsup
On the CPU:        ... --device cpu --num-nodes 2000 --batch-size 64
"""
import argparse
import json
import time

import numpy as np


def make_community_graph(num_nodes: int, avg_deg: int, rng):
  """The JAX example's graph (its lines 43-86), draw for draw:
  ``(rows, cols, te_idx, g_rows, g_cols, feat)``: the canonical undirected
  pairs, the held-out pairs' indices, the training graph's directed edges
  (both directions of the kept pairs) and the ``[N, 64]`` features."""
  n, ncom = num_nodes, 32
  comm = rng.integers(0, ncom, n).astype(np.int32)
  order = np.argsort(comm, kind='stable').astype(np.int32)
  counts = np.bincount(comm, minlength=ncom)
  offsets = np.zeros(ncom + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  e = n * avg_deg
  rows = rng.integers(0, n, e).astype(np.int32)
  intra = rng.random(e) < 0.9
  cols = np.empty(e, np.int32)
  rc = comm[rows[intra]]
  u = rng.random(intra.sum())
  cols[intra] = order[offsets[rc] + (u * counts[rc]).astype(np.int64)]
  cols[~intra] = rng.integers(0, n, (~intra).sum())
  feat = (comm[:, None] == np.arange(64) % ncom).astype(np.float32) + \
      0.5 * rng.standard_normal((n, 64)).astype(np.float32)
  # the split is on canonical undirected pairs, so no held-out edge's
  # reverse twin stays in the training graph; the kept pairs go back in
  # both directions
  lo = np.minimum(rows, cols).astype(np.int64)
  hi = np.maximum(rows, cols).astype(np.int64)
  uniq = np.unique(lo * n + hi)
  rows = (uniq // n).astype(np.int32)
  cols = (uniq % n).astype(np.int32)
  e = rows.shape[0]
  perm = rng.permutation(e)
  tr_idx, te_idx = perm[: int(e * 0.9)], perm[int(e * 0.9):]
  g_rows = np.concatenate([rows[tr_idx], cols[tr_idx]])
  g_cols = np.concatenate([cols[tr_idx], rows[tr_idx]])
  return rows, cols, te_idx, g_rows, g_cols, feat


def run(args, params=None):
  """Train and test as the JAX example does; returns ``(result, losses)``
  with the per-step losses as floats. ``params``: flax GraphSAGE
  parameters to start from (numpy leaves; default: torch's initialisation
  from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.sampler import NegativeSampling
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  rng = np.random.default_rng(0)
  rows, cols, te_idx, g_rows, g_cols, feat = make_community_graph(
      args.num_nodes, args.avg_deg, rng)
  ds = gtt.data.Dataset(device=device)
  ds.init_graph(np.stack([g_rows, g_cols]), num_nodes=args.num_nodes)
  ds.init_node_features(feat)

  loader = gtt.loader.LinkNeighborLoader(
      ds, [10, 5], np.stack([g_rows, g_cols]),
      neg_sampling=NegativeSampling('binary', 1),
      batch_size=args.batch_size, shuffle=True, drop_last=True, seed=0,
      device=device)
  # drop_last truncates less than one batch of the holdout
  test_loader = gtt.loader.LinkNeighborLoader(
      ds, [10, 5], np.stack([rows[te_idx], cols[te_idx]]),
      neg_sampling=NegativeSampling('binary', 1),
      batch_size=min(args.batch_size, len(te_idx)), shuffle=False,
      drop_last=True, seed=1, device=device)
  model = gtt.models.GraphSAGE(
      feat.shape[1], args.hidden, args.hidden, num_layers=2, device=device,
      generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, eval_step = train_lib.make_link_train_step(model)
  sync = torch.cuda.synchronize if cuda else (lambda: None)

  losses, accs, epoch_times = [], [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, acc = train_step(state,
                                    train_lib.link_batch_to_dict(batch))
      losses.append(loss)
      accs.append(acc)
    sync()
    epoch_times.append(time.perf_counter() - t0)
  test_accs = [eval_step(state, train_lib.link_batch_to_dict(b))
               for b in test_loader]
  sync()
  losses = [float(v) for v in losses]      # the host reads: after training
  result = {
      'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
      'steps_per_epoch': len(loader),
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'final_train_link_acc': round(float(accs[-1]), 4),
      'test_link_acc': round(float(np.mean([float(a) for a in test_accs])),
                             4),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
  }
  return result, losses


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--num-nodes', type=int, default=50_000)
  ap.add_argument('--avg-deg', type=int, default=12)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  result, _ = run(ap.parse_args(argv))
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
