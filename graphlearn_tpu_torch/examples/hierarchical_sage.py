"""Hierarchical typed GraphSAGE (trim per layer) on MAG-shaped data, on
the port.

Counterpart of ``examples/hetero/hierarchical_sage.py``: typed tree
batches lay nodes and edges out in positional hop blocks, so
``sampler.hetero_tree_layout`` gives per-type hop offsets and the RGNN's
hierarchical forward runs each layer over fixed typed prefixes, the
static counterpart of PyG's ``trim_to_layer``. The graph is the JAX
example's MAG-shaped synthetic (``make_mag_like``, draw for draw: paper,
author, institution and field_of_study types, seven edge types, 32-wide
features), fanouts ``[8, 4]`` per edge type. Trains the full and the
hierarchical forward from the same start (Adam at 3e-3) and prints one
JSON line with both's first and final loss, final accuracy and epoch
time.

Run on the card:   python -m graphlearn_tpu_torch.examples.hierarchical_sage
On the CPU:        ... --device cpu --n-paper 600 --batch-size 32
"""
import argparse
import json
import time

import numpy as np

CITES = ('paper', 'cites', 'paper')
WRITES = ('author', 'writes', 'paper')
AFFIL = ('author', 'affiliated_with', 'institution')
TOPIC = ('paper', 'has_topic', 'field_of_study')
NUM_CLASSES = 8


def rev(et):
  from graphlearn_tpu_torch.typing import reverse_edge_type
  return reverse_edge_type(et)


def community_pick(order, offsets, counts, comm_of, rng):
  u = rng.random(comm_of.shape[0])
  return order[offsets[comm_of] + (u * counts[comm_of]).astype(np.int64)]


def make_mag_like(n_paper, n_author, n_inst, n_field, ncls, rng):
  """The JAX HGT example's MAG-shaped synthetic, draw for draw:
  ``(cites, writes, affil, topic, feats, labels)``."""
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
    """(order, offsets, counts) community lookup for n_items entities,
    every community non-empty (round-robin base)."""
    c = (np.arange(n_items) % ncls).astype(np.int32)
    order_ = np.argsort(c, kind='stable').astype(np.int32)
    counts_ = np.bincount(c, minlength=ncls)
    offsets_ = np.zeros(ncls + 1, np.int64)
    np.cumsum(counts_, out=offsets_[1:])
    return order_, offsets_, counts_

  # authors -> institutions (institutions lean to one community)
  iorder, ioff, icnt = comm_table(n_inst)
  ia = np.arange(n_author, dtype=np.int32)
  ai = community_pick(iorder, ioff, icnt, acomm, rng).astype(np.int32)
  affil = np.stack([ia, ai])

  # papers -> fields (fields lean to one community)
  forder, foff, fcnt = comm_table(n_field)
  tp = np.repeat(np.arange(n_paper, dtype=np.int32), 2)
  tf = community_pick(forder, foff, fcnt, comm[tp], rng).astype(np.int32)
  topic = np.stack([tp, tf])

  f = 32
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


def run(args, params=None):
  """Train both variants as the JAX example does; returns ``(report,
  losses)``, ``losses`` the per-step floats by variant. ``params``: flax
  RGNN parameters of each variant (``{'full': ..., 'hierarchical':
  ...}``, numpy leaves) to start from (default: torch's initialisation
  from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  rng = np.random.default_rng(0)
  n_author, n_inst, n_field = args.n_paper // 2, 200, 500
  cites, writes, affil, topic, feats, label = make_mag_like(
      args.n_paper, n_author, n_inst, n_field, NUM_CLASSES, rng)
  edges = {CITES: cites, WRITES: writes, AFFIL: affil, TOPIC: topic,
           rev(WRITES): writes[::-1].copy(),
           rev(AFFIL): affil[::-1].copy(),
           rev(TOPIC): topic[::-1].copy()}
  nnodes = {'paper': args.n_paper, 'author': n_author,
            'institution': n_inst, 'field_of_study': n_field}
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph(edges, num_nodes={et: nnodes[et[0]] for et in edges})
  ds.init_node_features(feats)
  ds.init_node_labels({'paper': label})
  fan = {et: [8, 4] for et in edges}
  n_tr = int(args.n_paper * 0.2)
  model_etypes = tuple(rev(et) for et in edges)
  no, eo = gtt.sampler.hetero_tree_layout({'paper': args.batch_size},
                                          tuple(edges), fan)
  in_dims = {t: f.shape[1] for t, f in feats.items()}
  variants = {'full': {}, 'hierarchical': dict(hop_node_offsets=no,
                                               hop_edge_offsets=eo)}
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  report = {'model': 'hierarchical-hetero-SAGE', 'n_paper': args.n_paper,
            'device': torch.cuda.get_device_name(device) if cuda
            else 'cpu'}
  all_losses = {}
  for name, kw in variants.items():
    # a fresh loader per variant: the shuffle stream is stateful
    loader = gtt.loader.NeighborLoader(
        ds, fan, ('paper', np.arange(n_tr)), batch_size=args.batch_size,
        shuffle=True, drop_last=True, seed=0, dedup='tree', device=device)
    model = gtt.models.RGNN(
        model_etypes, in_dims, args.hidden, NUM_CLASSES, num_layers=2,
        out_ntype='paper', device=device,
        generator=torch.Generator().manual_seed(args.seed), **kw)
    if params is not None:
      model.load_state_dict(convert.params_from_flax(params[name], model),
                            strict=False)
    state = train_lib.create_train_state(model, lr=args.lr)
    train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
    # the JAX example's first step (its compile step, outside the timed
    # region) trains on one batch drawn before the epochs
    state, _, _ = train_step(state, train_lib.batch_to_dict(
        next(iter(loader))))
    losses, accs, epoch_times = [], [], []
    for _ in range(args.epochs):
      t0 = time.perf_counter()
      for batch in loader:
        state, loss, acc = train_step(state,
                                      train_lib.batch_to_dict(batch))
        losses.append(loss)
        accs.append(acc)
      sync()
      epoch_times.append(time.perf_counter() - t0)
    all_losses[name] = [float(v) for v in losses]
    report[name] = {
        'first_loss': round(all_losses[name][0], 4),
        'final_loss': round(all_losses[name][-1], 4),
        'final_acc': round(float(accs[-1]), 4),
        'epoch_time_s': round(float(np.mean(epoch_times)), 3),
    }
  return report, all_losses


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--n-paper', type=int, default=60_000)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  report, _ = run(ap.parse_args(argv))
  print(json.dumps(report), flush=True)
  return report


if __name__ == '__main__':
  main()
