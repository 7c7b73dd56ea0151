"""Typed RGNN training on an IGBH-shaped graph, on the port.

Counterpart of ``examples/igbh/train_rgnn.py``: the IGBH citation graph's
paper and author types with a typed RGNN classifying papers. IGBH is not
in the repository, so the JAX example's IGBH-shaped synthetic is built
here from the same numpy stream (``make_igbh_like``): papers carry
community labels, cites edges are 85% homophilous, each author writes
three papers of one community, 64-wide features. A tree-mode
``NeighborLoader`` draws typed batches (``cites [10, 5]``, ``writes
[5, 3]``, ``rev_writes [3, 2]``, batch 512, ``edge_dir='out'``) and the
RGNN (hidden 128, 2 layers, 16 classes) aggregates them with
``TreeHeteroConv``'s dense k-runs: ``--model rsage`` (SAGE convs) or
``--model rgat`` (4-head GAT convs, the reference's default). Adam at
3e-3; one JSON line with the first and final loss, the final train
accuracy and the mean epoch time.

Run on the card:   python -m graphlearn_tpu_torch.examples.train_rgnn
On the CPU:        ... --device cpu --n-paper 2000 --n-author 1000
                   --batch-size 64
"""
import argparse
import json
import time

import numpy as np

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
REV_WRITES = ('paper', 'rev_writes', 'author')
FANOUTS = {CITES: [10, 5], WRITES: [5, 3], REV_WRITES: [3, 2]}
NUM_CLASSES = 16


def make_igbh_like(n_paper, n_author, ncls, rng):
  """The JAX example's IGBH-shaped synthetic, draw for draw:
  ``(cites [2, 12 * n_paper], writes [2, 3 * n_author], {'paper':
  [n_paper, 64], 'author': [n_author, 64]} float32 features, [n_paper]
  int64 community labels)``."""
  comm = rng.integers(0, ncls, n_paper).astype(np.int32)
  order = np.argsort(comm, kind='stable').astype(np.int32)
  counts = np.bincount(comm, minlength=ncls)
  offsets = np.zeros(ncls + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  # cites: 85% intra-community
  e = n_paper * 12
  rows = rng.integers(0, n_paper, e).astype(np.int32)
  intra = rng.random(e) < 0.85
  cols = np.empty(e, np.int32)
  rc = comm[rows[intra]]
  u = rng.random(intra.sum())
  cols[intra] = order[offsets[rc] + (u * counts[rc]).astype(np.int64)]
  cols[~intra] = rng.integers(0, n_paper, (~intra).sum())
  cites = np.stack([rows, cols])
  # writes: each author writes ~3 papers of one community
  ac = rng.integers(0, ncls, n_author).astype(np.int32)
  wa = np.repeat(np.arange(n_author, dtype=np.int32), 3)
  u = rng.random(wa.shape[0])
  wp = order[offsets[ac[wa]] + (u * counts[ac[wa]]).astype(np.int64)]
  writes = np.stack([wa, wp])
  feats = {
      'paper': rng.standard_normal((n_paper, 64)).astype(np.float32),
      'author': rng.standard_normal((n_author, 64)).astype(np.float32),
  }
  return cites, writes, feats, comm.astype(np.int64)


def build_dataset(n_paper, n_author, device, seed=0):
  """``(dataset, labels)``: the example's graph (cites, writes and its
  reverse) with features and paper labels on ``device``."""
  import graphlearn_tpu_torch as gtt
  rng = np.random.default_rng(seed)
  cites, writes, feats, label = make_igbh_like(n_paper, n_author,
                                               NUM_CLASSES, rng)
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph({CITES: cites, WRITES: writes,
                 REV_WRITES: writes[::-1].copy()},
                num_nodes={CITES: n_paper, WRITES: n_author,
                           REV_WRITES: n_paper})
  ds.init_node_features(feats)
  ds.init_node_labels({'paper': label})
  return ds, label


def build_model(kind, batch_size, hidden, device, mode='tree_dense',
                etype_caps=None, generator=None, in_dim=64):
  """The example's RGNN: ``kind`` 'rsage' or 'rgat' (4 heads), ``mode``
  'tree_dense' (the example's), 'merge_dense' (over calibrated merge
  batches, with the loader's ``etype_caps``), 'hierarchical' or
  'segment', laid out for seed batches of ``batch_size``."""
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.typing import reverse_edge_type
  recs, no, eo = gtt.sampler.hetero_tree_blocks(
      {'paper': batch_size}, tuple(FANOUTS), FANOUTS, etype_caps=etype_caps)
  kw = {}
  if mode != 'segment':
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo)
  if mode in ('tree_dense', 'merge_dense'):
    kw.update({mode: True, 'tree_records': recs})
  return gtt.models.RGNN(
      tuple(reverse_edge_type(et) for et in FANOUTS),
      {'paper': in_dim, 'author': in_dim}, hidden, NUM_CLASSES,
      num_layers=2, conv='gat' if kind == 'rgat' else 'sage',
      heads=4 if kind == 'rgat' else 1, out_ntype='paper', device=device,
      generator=generator, **kw)


def run(args, params=None):
  """Train as the JAX example does; returns ``(result, losses)`` with the
  per-step losses as floats. ``params``: flax RGNN parameters to start
  from (numpy leaves; default: torch's initialisation from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  ds, _ = build_dataset(args.n_paper, args.n_author, device)
  # small runs: fewer train seeds than one batch would yield no batch
  n_tr = max(1, int(args.n_paper * 0.1))
  batch_size = min(args.batch_size, n_tr)
  loader = gtt.loader.NeighborLoader(
      ds, FANOUTS, ('paper', np.arange(n_tr)), batch_size=batch_size,
      shuffle=True, drop_last=True, seed=0, dedup='tree', device=device)
  model = build_model(args.model, batch_size, args.hidden, device,
                      generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model))
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
  sync = torch.cuda.synchronize if cuda else (lambda: None)

  losses, accs, epoch_times = [], [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, acc = train_step(state, train_lib.batch_to_dict(batch))
      losses.append(loss)
      accs.append(acc)
    sync()
    epoch_times.append(time.perf_counter() - t0)
  losses = [float(v) for v in losses]      # the host reads: after training
  result = {
      'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
      'model': args.model,
      'steps_per_epoch': len(loader),
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'final_train_acc': round(float(accs[-1]), 4),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
  }
  return result, losses


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--n-paper', type=int, default=100_000)
  ap.add_argument('--n-author', type=int, default=50_000)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=128)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--model', default='rsage', choices=['rsage', 'rgat'],
                  help="conv family (the reference's default is 'rgat' "
                       'with 4 heads)')
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
