"""The typed accuracy gate on an IGBH-shaped synthetic, on the port.

Counterpart of ``examples/igbh/train_rgnn_gate.py``: a paper/author graph
whose accuracy depends on the sampling mode's semantics. Papers cite
same-class papers and authors write same-class papers with probability
``--p-intra``; edge targets follow a power law within each type (the
products gate's ``draw_class_targets``); features carry a weak class
signal (``--feat-snr``), and the authors' carry an independent slice of
it that only typed 2-hop paths deliver. The graph is the JAX example's,
from the same numpy stream (``make_synthetic``).

- ``--mode segment``: exact-dedup merge batches, per-edge-type segment
  convs over the hierarchical layout; ``tree_dense``: tree batches and
  the dense k-run typed aggregation; ``merge_dense``: calibrated
  per-(hop, edge type) caps (``sampler.estimate_hetero_frontier_caps``)
  and the dense aggregation on exact merge batches.
- ``--conv sage`` / ``gat``: ``RGNN``; ``hgt``: ``HGT``. Every conv takes
  every mode. ``--bf16-model``: bfloat16 compute (parameters, optimizer
  and loss stay float32).

Adam at 2e-3; the last line is the JAX example's JSON line (test accuracy
at each requested epoch budget, first and final train loss, mean epoch
time).

Run on the card:   python -m graphlearn_tpu_torch.examples.train_rgnn_gate
                   --conv hgt --mode tree_dense
On the CPU:        ... --device cpu --n-paper 3000 --n-author 1500
                   --batch-size 64 --fanout 5 3 --epochs 1
"""
import argparse
import json
import time
import warnings

import numpy as np

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV = ('paper', 'rev_writes', 'author')


def powerlaw_weights(n, rng, alpha=1.68, dmax_frac=0.005):
  """Per-node popularity weights with a zipf-like tail (the products
  fit's exponent, as the homogeneous gate's)."""
  dmax = max(64, int(n * dmax_frac))
  d = np.arange(1, dmax + 1, dtype=np.float64)
  pmf = d ** -alpha
  pmf /= pmf.sum()
  target = rng.choice(d, size=n, p=pmf)
  return target / target.sum()


def make_synthetic(n_paper, n_author, ncls, feat_dim, p_intra, feat_snr,
                   avg_cites, avg_writes, rng):
  """The JAX example's synthetic, draw for draw: ``(cites, writes,
  paper features, author features, paper labels, train, valid, test
  paper ids)``."""
  from .train_sage_products import draw_class_targets
  comm_p = rng.integers(0, ncls, n_paper).astype(np.int32)
  comm_a = rng.integers(0, ncls, n_author).astype(np.int32)
  w_p = powerlaw_weights(n_paper, rng)
  e_c = n_paper * avg_cites
  c_rows = rng.integers(0, n_paper, e_c).astype(np.int32)
  c_cols = draw_class_targets(comm_p[c_rows], comm_p, w_p, p_intra, rng)
  cites = np.stack([c_rows, c_cols])
  e_w = n_author * avg_writes
  w_rows = rng.integers(0, n_author, e_w).astype(np.int32)
  w_cols = draw_class_targets(comm_a[w_rows], comm_p, w_p, p_intra, rng)
  writes = np.stack([w_rows, w_cols])
  # independent bases: papers carry slice A of the class signal, authors
  # slice B, which only typed 2-hop paths bring to a paper
  cen_p = rng.standard_normal((ncls, feat_dim)).astype(np.float32)
  cen_a = rng.standard_normal((ncls, feat_dim)).astype(np.float32)
  feat_p = cen_p[comm_p] * feat_snr + \
      rng.standard_normal((n_paper, feat_dim)).astype(np.float32)
  feat_a = cen_a[comm_a] * feat_snr + \
      rng.standard_normal((n_author, feat_dim)).astype(np.float32)
  indeg = np.bincount(c_cols, minlength=n_paper)
  q = np.percentile(indeg, [50, 90, 99])
  print(f'# typed gate graph: papers={n_paper} authors={n_author} '
        f'cites={e_c} writes={e_w}; cites in-degree mean='
        f'{indeg.mean():.1f} p50={q[0]:.0f} p90={q[1]:.0f} '
        f'p99={q[2]:.0f} max={indeg.max()}', flush=True)
  perm = rng.permutation(n_paper)
  n_tr, n_va = int(n_paper * 0.3), int(n_paper * 0.1)
  return (cites, writes, feat_p, feat_a, comm_p.astype(np.int64),
          perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:])


def build_model(args, fan, caps, device, generator=None):
  """The gate's model: ``HGT`` for ``--conv hgt``, else ``RGNN`` (4 GAT
  heads for 'gat'), over the typed layout of ``fan`` (hop offsets in
  every mode; the records for the dense ones)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.typing import reverse_edge_type
  recs, no, eo = gtt.sampler.hetero_tree_blocks(
      {'paper': args.batch_size}, tuple(fan), fan, etype_caps=caps)
  rev_et = tuple(reverse_edge_type(et) for et in fan)
  in_dims = {'paper': args.feat_dim, 'author': args.feat_dim}
  kw = dict(num_layers=len(args.fanout), out_ntype='paper',
            dtype=torch.bfloat16 if args.bf16_model else None,
            hop_node_offsets=no, hop_edge_offsets=eo,
            tree_records=recs if args.mode != 'segment' else None,
            merge_dense=args.mode == 'merge_dense', device=device,
            generator=generator)
  if args.conv == 'hgt':
    return gtt.models.HGT(('paper', 'author'), rev_et, args.hidden,
                          args.num_classes, heads=args.heads,
                          in_dims=in_dims, **kw)
  return gtt.models.RGNN(rev_et, in_dims, args.hidden, args.num_classes,
                         conv=args.conv,
                         heads=args.heads if args.conv == 'gat' else 1,
                         tree_dense=args.mode == 'tree_dense', **kw)


def run(args, params=None):
  """Train and evaluate as the JAX example does; returns ``(result,
  losses)`` with the per-step losses as floats. ``params``: flax
  parameters to start from (numpy leaves; default: torch's
  initialisation from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  t0 = time.time()
  (cites, writes, feat_p, feat_a, label_p, train_idx, _,
   test_idx) = make_synthetic(
      args.n_paper, args.n_author, args.num_classes, args.feat_dim,
      args.p_intra, args.feat_snr, args.avg_cites, args.avg_writes,
      np.random.default_rng(0))   # the graph is fixed across seeds
  print(f'# generated in {time.time() - t0:.1f}s', flush=True)
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph({CITES: cites, WRITES: writes, REV: writes[::-1].copy()},
                num_nodes={CITES: args.n_paper, WRITES: args.n_author,
                           REV: args.n_paper})
  ds.init_node_features({'paper': feat_p, 'author': feat_a})
  ds.init_node_labels({'paper': label_p})
  fan = {et: list(args.fanout) for et in (CITES, WRITES, REV)}
  hb = args.batch_size
  caps = None
  if args.mode == 'merge_dense':
    t0 = time.time()
    caps = gtt.sampler.estimate_hetero_frontier_caps(
        ds.graph, fan, {'paper': hb}, input_nodes={'paper': train_idx},
        num_probes=4, slack=1.5)
    print(f'# calibrated hetero caps in {time.time() - t0:.1f}s: '
          f'{ {"/".join(et): v for et, v in caps.items()} }', flush=True)
  dedup = 'tree' if args.mode == 'tree_dense' else 'merge'

  def mk_loader(idx, shuffle, seed, drop_last):
    return gtt.loader.NeighborLoader(
        ds, fan, ('paper', idx), batch_size=hb, shuffle=shuffle,
        drop_last=drop_last, seed=seed, dedup=dedup, frontier_caps=caps,
        overflow_policy='warn' if caps else 'raise', device=device)

  loader = mk_loader(train_idx, True, args.seed, True)
  test_loader = mk_loader(test_idx, False, args.seed + 1, False)
  model = build_model(args, fan, caps, device,
                      torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model),
                          strict=False)
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = train_lib.make_train_step(model, args.num_classes)
  eval_counts = train_lib.make_eval_counts(model)
  eval_ovf_flags = []

  def run_eval():
    correct = total = 0
    # an exhausted pass warns (and consumes the flag); an early break
    # leaves the device flag: keep it before the next pass resets it
    with warnings.catch_warnings(record=True) as wl:
      warnings.simplefilter('always')
      for i, batch in enumerate(test_loader):
        if args.eval_batches and i >= args.eval_batches:
          break
        c, t = eval_counts(train_lib.batch_to_dict(batch))
        correct, total = correct + c, total + t
    if test_loader._ovf_accum is not None:
      eval_ovf_flags.append(test_loader._ovf_accum)
    if any('overflowed' in str(w.message) for w in wl):
      eval_ovf_flags.append(True)
    return correct, total

  eval_at = sorted({int(x) for x in args.eval_epochs.split(',') if x})
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  losses, epoch_times, evals, train_ovf_epochs = [], [], {}, 0
  for epoch in range(args.epochs):
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
      warnings.simplefilter('always')
      model.train()
      for batch in loader:
        state, loss, _ = train_step(state, train_lib.batch_to_dict(batch))
        losses.append(loss)
    train_ovf_epochs += any('overflowed' in str(w.message) for w in wl)
    sync()
    epoch_times.append(time.perf_counter() - t0)
    if epoch + 1 in eval_at and epoch + 1 < args.epochs:
      model.eval()
      evals[epoch + 1] = run_eval()
  model.eval()
  evals[args.epochs] = run_eval()
  test_acc_at = {e: round(float(c) / max(float(t), 1.0), 4)
                 for e, (c, t) in sorted(evals.items())}
  if caps is not None:
    eval_ovf = any(bool(f) for f in eval_ovf_flags)
    print(f'# calibrated-caps overflow: train_epochs='
          f'{train_ovf_epochs}/{args.epochs} eval={eval_ovf}', flush=True)
  losses = [float(v) for v in losses]      # the host reads: after training
  return {
      'conv': args.conv, 'mode': args.mode, 'epochs': args.epochs,
      'steps_per_epoch': len(loader),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
      'first_train_loss': round(losses[0], 4),
      'final_train_loss': round(losses[-1], 4),
      'test_acc': test_acc_at[args.epochs],
      'test_acc_at': test_acc_at,
      'timing': 'dispatch-wall',
  }, losses


def parser():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=4)
  ap.add_argument('--eval-epochs', default='',
                  help='comma-separated earlier budgets to also eval at')
  ap.add_argument('--batch-size', type=int, default=1024)
  ap.add_argument('--fanout', type=int, nargs='+', default=[15, 10, 5])
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--heads', type=int, default=4)
  ap.add_argument('--lr', type=float, default=2e-3)
  ap.add_argument('--n-paper', type=int, default=100_000)
  ap.add_argument('--n-author', type=int, default=50_000)
  ap.add_argument('--num-classes', type=int, default=8)
  ap.add_argument('--feat-dim', type=int, default=64)
  ap.add_argument('--feat-snr', type=float, default=0.1)
  ap.add_argument('--p-intra', type=float, default=0.6)
  ap.add_argument('--avg-cites', type=int, default=12)
  ap.add_argument('--avg-writes', type=int, default=6)
  ap.add_argument('--eval-batches', type=int, default=50)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--conv', default='sage', choices=['sage', 'gat', 'hgt'])
  ap.add_argument('--mode', default='segment',
                  choices=['segment', 'tree_dense', 'merge_dense'])
  ap.add_argument('--bf16-model', action='store_true')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  return ap


def main(argv=None):
  result, _ = run(parser().parse_args(argv))
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
