"""HGT on an OGB-MAG-shaped heterogeneous graph, on the port.

Counterpart of ``examples/hetero/train_hgt_mag.py``: OGB-MAG is not in
the repository, so the JAX example's MAG-shaped synthetic is built here
from the same numpy stream (``make_mag_like``): 60,000 papers, 30,000
authors, 200 institutions and 500 fields of study with 32-wide float32
features, papers carrying one of 8 venue communities (the labels),
homophilous citations, and authors and fields leaning to communities;
the four stored edge types plus the reverses of writes, affiliated_with
and has_topic (7 edge types). A tree-mode ``NeighborLoader`` draws
``[10, 10]`` per edge type from paper seeds (batch 512, ``edge_dir='out'``)
and ``HGT`` (hidden 64, 4 heads, 2 layers) classifies them with the dense
k-run typed attention over the hierarchical tree layout
(``sampler.hetero_tree_blocks``). Adam at 3e-3; the last line is the JAX
example's JSON line (first and final loss, test accuracy, mean epoch
wall time).

Run on the card:   python -m graphlearn_tpu_torch.examples.train_hgt_mag
On the CPU:        ... --device cpu --n-paper 3000 --batch-size 64
"""
import argparse
import json
import time

import numpy as np

from ..typing import reverse_edge_type as rev

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
AFFIL = ('author', 'affiliated_with', 'institution')
TOPIC = ('paper', 'has_topic', 'field_of_study')
# the stored edge types: the four and the reverses of three (the
# reference's ToUndirected(merge=True)), in the JAX example's order
EDGE_TYPES = (CITES, WRITES, AFFIL, TOPIC, rev(WRITES), rev(AFFIL),
              rev(TOPIC))
NODE_TYPES = ('paper', 'author', 'institution', 'field_of_study')
FANOUTS = {et: [10, 10] for et in EDGE_TYPES}
NUM_CLASSES = 8
FEAT_DIM = 32


def community_pick(order, offsets, counts, comm_of, rng):
  u = rng.random(comm_of.shape[0])
  return order[offsets[comm_of] + (u * counts[comm_of]).astype(np.int64)]


def make_mag_like(n_paper, n_author, n_inst, n_field, ncls, rng):
  """The JAX example's MAG-shaped synthetic, draw for draw: ``(cites,
  writes, affiliated_with, has_topic, {type: [n, 32] float32 features},
  [n_paper] int64 labels)``."""
  comm = rng.integers(0, ncls, n_paper).astype(np.int32)
  order = np.argsort(comm, kind='stable').astype(np.int32)
  counts = np.bincount(comm, minlength=ncls)
  offsets = np.zeros(ncls + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  # cites: 80% intra-community
  e = n_paper * 8
  pr = rng.integers(0, n_paper, e).astype(np.int32)
  intra = rng.random(e) < 0.8
  pc = rng.integers(0, n_paper, e).astype(np.int32)
  pc[intra] = community_pick(order, offsets, counts, comm[pr[intra]], rng)
  cites = np.stack([pr, pc])
  # each author has a community and writes ~4 papers mostly in it
  acomm = rng.integers(0, ncls, n_author).astype(np.int32)
  wa = np.repeat(np.arange(n_author, dtype=np.int32), 4)
  wp = community_pick(order, offsets, counts, acomm[wa], rng)
  writes = np.stack([wa, wp])

  def comm_table(n_items):
    """Every community non-empty: a round-robin community per item."""
    c = (np.arange(n_items) % ncls).astype(np.int32)
    order_ = np.argsort(c, kind='stable').astype(np.int32)
    counts_ = np.bincount(c, minlength=ncls)
    offsets_ = np.zeros(ncls + 1, np.int64)
    np.cumsum(counts_, out=offsets_[1:])
    return order_, offsets_, counts_

  iorder, ioff, icnt = comm_table(n_inst)
  ia = np.arange(n_author, dtype=np.int32)
  ai = community_pick(iorder, ioff, icnt, acomm, rng).astype(np.int32)
  affil = np.stack([ia, ai])
  forder, foff, fcnt = comm_table(n_field)
  tp = np.repeat(np.arange(n_paper, dtype=np.int32), 2)
  tf = community_pick(forder, foff, fcnt, comm[tp], rng).astype(np.int32)
  topic = np.stack([tp, tf])
  f = FEAT_DIM
  centers = rng.standard_normal((ncls, f)).astype(np.float32)
  feats = {
      'paper': (centers[comm] * 0.2 +
                rng.standard_normal((n_paper, f))).astype(np.float32),
      'author': rng.standard_normal((n_author, f)).astype(np.float32),
      'institution': rng.standard_normal((n_inst, f)).astype(np.float32),
      'field_of_study':
          rng.standard_normal((n_field, f)).astype(np.float32),
  }
  return cites, writes, affil, topic, feats, comm.astype(np.int64)


def build_dataset(n_paper, device):
  """The example's typed graph (``EDGE_TYPES``) with features and paper
  labels on ``device``."""
  import graphlearn_tpu_torch as gtt
  rng = np.random.default_rng(0)
  n_author, n_inst, n_field = n_paper // 2, 200, 500
  cites, writes, affil, topic, feats, label = make_mag_like(
      n_paper, n_author, n_inst, n_field, NUM_CLASSES, rng)
  arrays = (cites, writes, affil, topic, writes[::-1].copy(),
            affil[::-1].copy(), topic[::-1].copy())
  nnodes = dict(zip(NODE_TYPES, (n_paper, n_author, n_inst, n_field)))
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph(dict(zip(EDGE_TYPES, arrays)),
                num_nodes={et: nnodes[et[0]] for et in EDGE_TYPES})
  ds.init_node_features(feats)
  ds.init_node_labels({'paper': label})
  return ds


def build_model(batch_size, hidden, heads, device, mode='tree_dense',
                etype_caps=None, generator=None, dtype=None):
  """The example's HGT laid out for paper-seed batches of ``batch_size``:
  ``mode`` 'tree_dense' (the example's), 'merge_dense' (over calibrated
  merge batches, with the loader's ``etype_caps``), 'hierarchical' or
  'segment'."""
  import graphlearn_tpu_torch as gtt
  recs, no, eo = gtt.sampler.hetero_tree_blocks(
      {'paper': batch_size}, EDGE_TYPES, FANOUTS, etype_caps=etype_caps)
  kw = {}
  if mode != 'segment':
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo)
  if mode in ('tree_dense', 'merge_dense'):
    kw.update(tree_records=recs, merge_dense=mode == 'merge_dense')
  return gtt.models.HGT(
      NODE_TYPES, tuple(rev(et) for et in EDGE_TYPES), hidden, NUM_CLASSES,
      heads=heads, num_layers=2, out_ntype='paper', dtype=dtype,
      in_dims={t: FEAT_DIM for t in NODE_TYPES}, device=device,
      generator=generator, **kw)


def run(args, params=None):
  """Train as the JAX example does; returns ``(result, losses)`` with the
  per-step losses as floats. ``params``: flax HGT parameters to start
  from (numpy leaves; default: torch's initialisation from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  ds = build_dataset(args.n_paper, device)
  n_tr = int(args.n_paper * 0.2)
  loader = gtt.loader.NeighborLoader(
      ds, FANOUTS, ('paper', np.arange(n_tr)), batch_size=args.batch_size,
      shuffle=True, drop_last=True, seed=0, dedup='tree', device=device)
  test_loader = gtt.loader.NeighborLoader(
      ds, FANOUTS, ('paper', np.arange(n_tr, int(args.n_paper * 0.25))),
      batch_size=args.batch_size, shuffle=False, drop_last=False, seed=1,
      dedup='tree', device=device)
  model = build_model(args.batch_size, args.hidden, args.heads, device,
                      generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model))
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
  eval_counts = train_lib.make_eval_counts(model)
  sync = torch.cuda.synchronize if cuda else (lambda: None)

  losses, epoch_times = [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, _ = train_step(state, train_lib.batch_to_dict(batch))
      losses.append(loss)
    sync()
    epoch_times.append(time.perf_counter() - t0)
  correct = total = 0
  model.eval()
  for batch in test_loader:
    c, t = eval_counts(train_lib.batch_to_dict(batch))
    correct, total = correct + c, total + t
  losses = [float(v) for v in losses]      # the host reads: after training
  result = {
      'model': 'HGT', 'n_paper': args.n_paper, 'epochs': args.epochs,
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'test_acc': round(float(correct) / max(float(total), 1.0), 4),
      'epoch_time_s_wall': round(float(np.mean(epoch_times)), 3),
  }
  return result, losses


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--n-paper', type=int, default=60_000)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--heads', type=int, default=4)
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
