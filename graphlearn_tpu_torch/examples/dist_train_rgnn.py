"""Distributed typed RGNN training (IGBH-shaped) over P graph shards, on
the port.

Counterpart of ``examples/igbh/dist_train_rgnn.py``: the IGBH-shaped
synthetic of ``examples.train_rgnn`` (``make_igbh_like``, draw for draw),
each edge type partitioned by its CSR key's owner (``v % P`` per node
type), a per-type ``DistFeature`` store and the papers' labels. A
tree-mode typed ``DistNeighborLoader`` (``cites [5, 3]``, ``writes [3,
2]``, ``rev_writes [2, 2]``) draws per-shard typed batches through the
typed distributed engine, whose positional layout is
``sampler.hetero_tree_layout``'s, so each shard's RGNN runs the
hierarchical (trim-per-layer) forward. The data-parallel step is the
package's (``loader.pipeline.data_parallel_step`` with
``models.train.make_loss_fn``: masked seed cross-entropy). One JSON
line: the first and final loss, the final train accuracy and the mean
epoch time.

Run on the card:   python -m graphlearn_tpu_torch.examples.dist_train_rgnn
On the CPU:        ... --device cpu --n-paper 2000 --n-author 1000
                   --batch-size 32
"""
import argparse
import json
import time

import numpy as np
import torch

from .train_rgnn import CITES, REV_WRITES, WRITES, make_igbh_like

NUM_CLASSES = 16
FANOUTS = {CITES: [5, 3], WRITES: [3, 2], REV_WRITES: [2, 2]}


def build_dataset(n_paper: int, n_author: int, mesh, rng, **feature_kw):
  """The JAX example's typed partitions on ``mesh``: ``(DistDataset,
  number of training papers)``; ``feature_kw`` go to each type's
  ``DistFeature``."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.typing import GraphPartitionData
  nparts = mesh.num_partitions
  cites, writes, feats, label = make_igbh_like(n_paper, n_author,
                                               NUM_CLASSES, rng)
  pb = {'paper': (np.arange(n_paper) % nparts).astype(np.int32),
        'author': (np.arange(n_author) % nparts).astype(np.int32)}
  typed = {CITES: (cites, 'paper'), WRITES: (writes, 'author'),
           REV_WRITES: (writes[::-1].copy(), 'paper')}
  parts = []
  for p in range(nparts):
    part = {}
    for et, (ei, key_t) in typed.items():
      m = pb[key_t][ei[0]] == p
      part[et] = GraphPartitionData(
          edge_index=ei[:, m], eids=np.nonzero(m)[0].astype(np.int64))
    parts.append(part)
  dg = gdist.DistHeteroGraph(nparts, 0, parts, pb)
  df = {}
  for t, f in feats.items():
    blocks = []
    for p in range(nparts):
      ids = np.nonzero(pb[t] == p)[0]
      blocks.append((ids.astype(np.int64), f[ids]))
    df[t] = gdist.DistFeature(nparts, blocks, pb[t], mesh, **feature_kw)
  ds = gdist.DistDataset(nparts, 0, dg, df, node_labels={'paper': label})
  return ds, int(n_paper * 0.2)


def build_model(batch_size: int, hidden: int, device, generator=None,
                conv: str = 'sage', heads: int = 1, fanouts=None):
  """The hierarchical RGNN of the typed tree batches (of ``fanouts``,
  default the example's)."""
  from graphlearn_tpu_torch.models import RGNN
  from graphlearn_tpu_torch.sampler import hetero_tree_layout
  from graphlearn_tpu_torch.typing import reverse_edge_type
  fanouts = fanouts or FANOUTS
  etypes = tuple(reverse_edge_type(et) for et in fanouts)
  no, eo = hetero_tree_layout({'paper': batch_size}, tuple(fanouts),
                              fanouts)
  return RGNN(etypes, {'paper': 64, 'author': 64}, hidden, NUM_CLASSES,
              num_layers=2, conv=conv, heads=heads, out_ntype='paper',
              hop_node_offsets=no, hop_edge_offsets=eo, device=device,
              generator=generator)


def fields(batch) -> dict:
  """The stacked ``[L, ...]`` step inputs of a typed batch."""
  return dict(x=batch.x, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask, y=batch.y['paper'],
              num_seed_nodes=batch.num_sampled_nodes['paper'][:, 0])


def make_step(model, mesh):
  """``step(state, batch) -> (state, loss, acc)``: the package's
  data-parallel step with the masked seed cross-entropy."""
  from graphlearn_tpu_torch.loader.pipeline import (data_parallel_step,
                                                    shard_batches)
  from graphlearn_tpu_torch.models.train import make_loss_fn
  loss_fn = make_loss_fn(model, NUM_CLASSES)

  def step(state, batch):
    loss, acc = data_parallel_step(state.optimizer, loss_fn,
                                   shard_batches(fields(batch)), mesh)
    return state._replace(step=state.step + 1), loss, acc

  return step


def parser():
  ap = argparse.ArgumentParser()
  ap.add_argument('--epochs', type=int, default=1)
  ap.add_argument('--n-paper', type=int, default=20_000)
  ap.add_argument('--n-author', type=int, default=10_000)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--hidden', type=int, default=64)
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
  from graphlearn_tpu_torch.models import convert, create_train_state
  ctx = gdist.init_worker_group(num_partitions=args.num_partitions,
                                devices=args.device)
  mesh = ctx.mesh
  rng = np.random.default_rng(0)
  ds, n_tr = build_dataset(args.n_paper, args.n_author, mesh, rng)
  loader = gdist.DistNeighborLoader(
      ds, FANOUTS, ('paper', np.arange(n_tr)), batch_size=args.batch_size,
      shuffle=True, drop_last=True, seed=0, mesh=mesh, dedup='tree')
  model = build_model(args.batch_size, args.hidden, mesh.device,
                      torch.Generator().manual_seed(0))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model),
                          strict=False)
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
  result = {
      'mesh_size': ctx.num_partitions,
      'first_loss': round(float(losses[0]), 4),
      'final_loss': round(float(losses[-1]), 4),
      'final_train_acc': round(float(accs[-1]), 4),
      'epoch_time_s': round(float(np.mean(epoch_times)), 3),
  }
  return result, model


def main(argv=None):
  result, _ = run(parser().parse_args(argv))
  print(json.dumps(result), flush=True)


if __name__ == '__main__':
  main()
