"""GraphSAGE on ogbn-products, trained with the port.

The port of ``examples/train_sage_ogbn_products.py``: 3-layer SAGE,
hidden 256, fanouts [15, 10, 5], batch 1024, Adam at 3e-3. With
``--data-dir`` it reads a staged ``ogbn_products.npz`` when one is there
(edge_index [2, E], feat [N, 100] float32, label [N] int64, train_idx /
valid_idx / test_idx); otherwise it generates the JAX example's
products-scale synthetic graph (planted communities as labels, a weak
feature signal, in-degrees from the products power-law fit), with its
own numpy copy of the generator.

- ``--dedup tree`` (default): tree batches, the layered ``tree_dense``
  forward (the layered segment forward under ``--node-budget``, whose
  truncated blocks the dense reshape cannot take).
- ``--calibrate``: exact dedup (the merge engine) under calibrated
  frontier caps and the loader's overflow guard, the layered
  ``merge_dense`` forward.
- ``--strategy block``: block (cluster) sampling over aligned 16-wide CSR
  blocks; ``--padded-window W``: hops from a ``[N, W]`` padded table,
  reseeded each epoch; ``--node-budget B``: every hop frontier clamped to
  B nodes; ``--bf16-features``: a bfloat16 feature table;
  ``--bf16-model``: bfloat16 compute in the convs (parameters, optimizer
  and loss stay float32). The JAX example's flags, with its meanings and
  defaults.

Each epoch is the per-step loop ``loader -> batch_to_dict ->
train_step``; losses stay on the device until the end, then a capped
eval pass counts correct test seeds through ``make_eval_counts``. The
last line of the output is one JSON object. ``--device`` defaults to the
card.

Run: python -m graphlearn_tpu_torch.examples.train_sage_products --epochs 3
"""
import argparse
import json
import os
import time

import numpy as np

# ogbn-products' published summary statistics, which the degree model is
# fitted to: N, 61,859,140 undirected edges (mean degree ~50.5), max
# degree 17,481
PRODUCTS_N = 2_449_029
PRODUCTS_MEAN_DEG = 50.5
PRODUCTS_MAX_DEG = 17_481


def load_staged(data_dir):
  path = os.path.join(data_dir, 'ogbn_products.npz')
  if not os.path.exists(path):
    return None
  z = np.load(path)
  return (z['edge_index'], z['feat'], z['label'], z['train_idx'],
          z['valid_idx'], z['test_idx'], int(z['label'].max()) + 1)


def fit_powerlaw_alpha(mean_deg, dmax):
  """Exponent of a truncated discrete power law ``P(d) ~ d^-alpha`` on
  ``[1, dmax]`` whose mean is ``mean_deg`` (bisection)."""
  d = np.arange(1, dmax + 1, dtype=np.float64)

  def mean_of(alpha):
    w = d ** -alpha
    return float((d * w).sum() / w.sum())

  lo, hi = 1.01, 4.0
  for _ in range(60):
    mid = 0.5 * (lo + hi)
    if mean_of(mid) > mean_deg:
      lo = mid
    else:
      hi = mid
  return 0.5 * (lo + hi)


def powerlaw_degree_weights(num_nodes, avg_deg, rng):
  """Per-node popularity weights whose in-degree distribution is the
  products power-law fit, its cutoff scaled with this graph's edge share
  (the tail keeps its shape at a smaller N)."""
  e = num_nodes * avg_deg
  e_products = PRODUCTS_N * PRODUCTS_MEAN_DEG
  dmax = max(64, int(PRODUCTS_MAX_DEG * e / e_products))
  alpha = fit_powerlaw_alpha(PRODUCTS_MEAN_DEG, PRODUCTS_MAX_DEG)
  d = np.arange(1, dmax + 1, dtype=np.float64)
  pmf = d ** -alpha
  pmf /= pmf.sum()
  target = rng.choice(d, size=num_nodes, p=pmf)
  return target / target.sum(), alpha, dmax


def draw_class_targets(rows_comm, comm, w, p_intra, rng):
  """Power-law-weighted edge targets, ``p_intra`` of them within the
  source's class (one searchsorted over class-ordered cumulative weights
  serves the global and the within-class draws)."""
  n = comm.shape[0]
  num_classes = int(comm.max()) + 1
  order = np.argsort(comm, kind='stable').astype(np.int32)
  cw = np.cumsum(w[order])
  counts = np.bincount(comm, minlength=num_classes)
  offsets = np.zeros(num_classes + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  bounds = np.concatenate([[0.0], cw])[offsets]
  base, total_c = bounds[:-1], np.diff(bounds)
  e = rows_comm.shape[0]
  intra = rng.random(e) < p_intra
  cols = np.empty(e, np.int32)
  rc = rows_comm[intra]
  u = rng.random(intra.sum())
  pos = np.searchsorted(cw, base[rc] + u * total_c[rc], side='right')
  cols[intra] = order[np.minimum(pos, n - 1)]
  u2 = rng.random((~intra).sum())
  pos2 = np.searchsorted(cw, u2 * cw[-1], side='right')
  cols[~intra] = order[np.minimum(pos2, n - 1)]
  return cols


def make_synthetic(num_nodes, avg_deg, num_classes, feat_dim, p_intra,
                   feat_snr, rng):
  """The products-matched community graph: labels are communities,
  ``p_intra`` of the edges stay within the source's community, edge
  targets follow the products degree fit, features are the community
  centre times ``feat_snr`` plus unit noise; ~8% train / 2% valid / the
  rest test. The same rng calls as the JAX example's."""
  comm = rng.integers(0, num_classes, num_nodes).astype(np.int32)
  w, alpha, dmax = powerlaw_degree_weights(num_nodes, avg_deg, rng)
  e = num_nodes * avg_deg
  rows = rng.integers(0, num_nodes, e).astype(np.int32)
  cols = draw_class_targets(comm[rows], comm, w, p_intra, rng)
  indeg = np.bincount(cols, minlength=num_nodes)
  q = np.percentile(indeg, [50, 90, 99])
  print(f'# degree model: products power-law fit alpha={alpha:.3f}; this '
        f'graph: scaled dmax={dmax}, realized in-degree mean='
        f'{indeg.mean():.1f} p50={q[0]:.0f} p90={q[1]:.0f} p99={q[2]:.0f} '
        f'max={indeg.max()}', flush=True)
  centers = rng.standard_normal((num_classes, feat_dim)).astype(np.float32)
  feat = centers[comm] * feat_snr + \
      rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
  perm = rng.permutation(num_nodes)
  n_tr, n_va = int(num_nodes * 0.08), int(num_nodes * 0.02)
  return (np.stack([rows, cols]), feat, comm.astype(np.int64),
          perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:],
          num_classes)


def make_loader(gtt, ds, args, seeds, shuffle, seed, cal_caps, device):
  """The example's loader over ``seeds`` with the flags' sampling modes."""
  return gtt.loader.NeighborLoader(
      ds, args.fanout, seeds, batch_size=args.batch_size, shuffle=shuffle,
      drop_last=shuffle, seed=seed, dedup=args.dedup, strategy=args.strategy,
      node_budget=args.node_budget, padded_window=args.padded_window,
      frontier_caps=cal_caps, device=device)


def build_model(gtt, args, feat_dim, ncls, cal_caps, device, generator):
  """GraphSAGE as the JAX example builds it
  (``examples/train_sage_ogbn_products.py:283-313``): tree batches take
  the layered forward over ``tree_hop_offsets`` (the dense reshape
  without a node budget, the segment convs under one); exact-dedup
  batches the layered ``merge_dense`` forward over ``merge_hop_offsets``;
  ``--bf16-model`` runs the convs in bfloat16."""
  import torch

  from graphlearn_tpu_torch.models import train as train_lib
  mdtype = torch.bfloat16 if args.bf16_model else None
  if args.dedup == 'tree':
    no, eo = train_lib.tree_hop_offsets(args.batch_size, args.fanout,
                                        args.node_budget)
    dense = dict(tree_dense=args.node_budget is None)
  else:
    no, eo = train_lib.merge_hop_offsets(args.batch_size, args.fanout,
                                         args.node_budget, cal_caps)
    dense = dict(merge_dense=True)
  return gtt.models.GraphSAGE(
      feat_dim, args.hidden, ncls, num_layers=len(args.fanout),
      hop_node_offsets=no, hop_edge_offsets=eo, fanouts=args.fanout,
      device=device, generator=generator, dtype=mdtype, **dense)


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--data-dir', default=os.environ.get('OGBN_DATA', ''))
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--batch-size', type=int, default=1024)
  ap.add_argument('--fanout', type=int, nargs='+', default=[15, 10, 5])
  ap.add_argument('--hidden', type=int, default=256)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--num-nodes', type=int, default=2_449_029)
  ap.add_argument('--avg-deg', type=int, default=25)
  ap.add_argument('--feat-snr', type=float, default=0.1)
  ap.add_argument('--p-intra', type=float, default=0.58)
  ap.add_argument('--eval-batches', type=int, default=200,
                  help='cap on test batches (0 = all)')
  ap.add_argument('--eval-epochs', default='',
                  help='comma-separated intermediate epochs to also '
                       'evaluate at; the last epoch is always evaluated')
  ap.add_argument('--seed', type=int, default=0,
                  help='training-stream seed (shuffle, sampling, model '
                       'init); the synthetic graph stays fixed')
  ap.add_argument('--dedup', default='tree',
                  choices=['auto', 'map', 'sort', 'merge', 'tree'],
                  help="'tree' (default): tree batches; the others: the "
                       'exact-dedup merge engine')
  ap.add_argument('--calibrate', action='store_true',
                  help='exact dedup under calibrated frontier caps and the '
                       "loader's overflow guard (implies --dedup map)")
  ap.add_argument('--bf16-features', action='store_true',
                  help='store the feature table in bfloat16')
  ap.add_argument('--bf16-model', action='store_true',
                  help='bfloat16 compute in the convs; parameters, '
                       'optimizer and loss stay float32')
  ap.add_argument('--padded-window', type=int, default=None,
                  help='sample from a dense [N, W] padded adjacency (rows '
                       'with deg > W sample a W-subset, reseeded each '
                       'epoch)')
  ap.add_argument('--node-budget', type=int, default=None,
                  help='clamp every hop frontier to this many nodes '
                       '(truncates expansion beyond the budget)')
  ap.add_argument('--strategy', default='random',
                  choices=['random', 'block'],
                  help="'block': cluster sampling over aligned 16-wide CSR "
                       'blocks (exact uniform marginals)')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  args = ap.parse_args(argv)

  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'

  staged = load_staged(args.data_dir) if args.data_dir else None
  if staged is not None:
    src = 'ogbn-products (staged)'
    ei, feat, label, train_idx, valid_idx, test_idx, ncls = staged
  else:
    src = f'synthetic products-scale (N={args.num_nodes})'
    t0 = time.time()
    ei, feat, label, train_idx, valid_idx, test_idx, ncls = make_synthetic(
        args.num_nodes, args.avg_deg, 47, 100, args.p_intra, args.feat_snr,
        np.random.default_rng(0))
    print(f'# generated {src} E={ei.shape[1]} in {time.time() - t0:.1f}s',
          flush=True)

  t0 = time.time()
  ds = gtt.data.Dataset(device=device)
  ds.init_graph(ei, num_nodes=feat.shape[0])
  ds.init_node_features(
      feat, dtype=torch.bfloat16 if args.bf16_features else None)
  ds.init_node_labels(label)
  print(f'# dataset built on {device} in {time.time() - t0:.1f}s', flush=True)

  cal_caps = None
  if args.calibrate:
    if args.dedup == 'tree':
      print('# --calibrate implies exact dedup; switching --dedup tree -> '
            'map', flush=True)
      args.dedup = 'map'
    t0 = time.time()
    cal_caps = gtt.sampler.calibrate.estimate_frontier_caps(
        ds.graph, args.fanout, args.batch_size, input_nodes=train_idx,
        num_probes=5, slack=1.5)
    print(f'# calibrated frontier caps {cal_caps} in '
          f'{time.time() - t0:.1f}s', flush=True)

  loader = make_loader(gtt, ds, args, train_idx, True, args.seed, cal_caps,
                       device)
  test_loader = make_loader(gtt, ds, args, test_idx, False, args.seed + 1,
                            cal_caps, device)
  model = build_model(gtt, args, feat.shape[1], ncls, cal_caps, device,
                      torch.Generator().manual_seed(args.seed))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = train_lib.make_train_step(model, ncls)
  eval_counts = train_lib.make_eval_counts(model)
  sync = torch.cuda.synchronize if cuda else (lambda: None)

  def run_eval():
    """One capped eval pass: device counts and its wall seconds."""
    correct = total = None
    t0 = time.perf_counter()
    for i, batch in enumerate(test_loader):
      if args.eval_batches and i >= args.eval_batches:
        break
      c, t = eval_counts(train_lib.batch_to_dict(batch))
      correct = c if correct is None else correct + c
      total = t if total is None else total + t
    sync()
    return correct, total, time.perf_counter() - t0

  eval_at = sorted({int(x) for x in args.eval_epochs.split(',') if x})
  epoch_times, loss_hist, acc_hist = [], [], []
  evals = {}
  for epoch in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, acc = train_step(state, train_lib.batch_to_dict(batch))
      loss_hist.append(loss)
      acc_hist.append(acc)
    sync()
    epoch_times.append(time.perf_counter() - t0)
    if epoch + 1 in eval_at and epoch + 1 < args.epochs:
      evals[epoch + 1] = run_eval()
  evals[args.epochs] = run_eval()

  # the host reads: after training
  test_acc_at = {e: round(float(c) / max(float(t), 1.0), 4)
                 for e, (c, t, _) in sorted(evals.items())}
  _, total, eval_time = evals[args.epochs]
  if cal_caps is not None:
    # finished train epochs passed the loader's guard; the capped eval
    # pass breaks its iterator, so its flag is read here
    eval_ovf = test_loader.check_overflow()
    print(f'# calibrated caps {cal_caps}: no overflow across {args.epochs} '
          f'train epochs (loader overflow guard); eval batches '
          f'overflow={eval_ovf}', flush=True)
  print(json.dumps({
      'source': src, 'device': (torch.cuda.get_device_name(device) if cuda
                                else 'cpu'),
      'dedup': args.dedup, 'frontier_caps': cal_caps,
      'strategy': args.strategy, 'padded_window': args.padded_window,
      'node_budget': args.node_budget, 'bf16_features': args.bf16_features,
      'bf16_model': args.bf16_model,
      'epochs': args.epochs, 'steps_per_epoch': len(loader),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
      'epoch_times': [round(t, 3) for t in epoch_times],
      'final_train_loss': round(float(loss_hist[-1]), 4),
      'final_train_acc': round(float(acc_hist[-1]), 4),
      'first_train_loss': round(float(loss_hist[0]), 4),
      'test_acc': test_acc_at[args.epochs], 'test_acc_at': test_acc_at,
      'test_seeds_evaluated': int(float(total)),
      'eval_time_s': round(eval_time, 3),
      'timing': 'host wall clock, synchronised at each epoch end',
  }), flush=True)


if __name__ == '__main__':
  main()
