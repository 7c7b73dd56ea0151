"""GraphSAGE where the feature table exceeds the device budget
(papers100M-shaped), trained with the port's hot/cold feature store.

The port of ``examples/train_sage_papers_scale.py`` in its hot/cold
mode: a synthetic graph built draw for draw as the JAX example builds it
(default 10M nodes, average degree 8 with a zipf(1.3) head, 128 f32
features: 4.77 GB against a 2 GB hot budget, so ``split_ratio`` ~0.42),
its rows reordered hot-first by in-degree (``sort_by_in_degree``), the
hot prefix on the device and the cold tail in page-locked host memory.
On the card every feature lookup is one launch of the hot/cold kernel,
which reads the cold rows over UVA with no host sync. Block sampling,
fanouts [5, 5], batch 256, the layered segment forward, Adam at 3e-3;
the hot hit rate counts real lookups only (FILL pads read storage row 0,
always hot, and are left out).

The three-tier mode (``--spill-dir DIR``), as the JAX example's
``main_tiered``: the features span the device (``--hot-gb``), host RAM
(``--warm-gb``) and memory-mapped chunk files under DIR (the rest), in a
``storage.TieredFeature`` sorted hot-first; one reactive tiered batch
(the JAX example's template batch), then one epoch of
``storage.TieredScanTrainer`` (``--chunk-size`` K; its chunks captured
as CUDA graphs on the card) truncated to ``--steps`` steps over the tree
engine's random hops. The prologue plans the epoch's exact disk miss set
and a staging worker feeds each chunk ahead of the device. Its JSON line
carries the JAX example's keys (``tiers``, ``staged_rows``,
``prefetch_miss``, ``prefetch_hit_rate``, ``plan``, ``epoch_wall_s``).

Run on the card:  python -m graphlearn_tpu_torch.examples.train_sage_papers_scale
On the CPU:       ... --device cpu --num-nodes 20000 --hot-gb 0.004
Three tiers:      ... --spill-dir DIR [--warm-gb 1.0 --chunk-size 8]
"""
import argparse
import json
import time

import numpy as np

NUM_CLASSES = 16
HIDDEN = 64


def make_graph(num_nodes: int, avg_deg: int, feat_dim: int, rng):
  """The JAX example's synthetic (its lines 68-74 and 84-92), draw for
  draw: ``(rows, cols, feat, label)``; each node's label is its first
  out-neighbour's id class."""
  n = num_nodes
  e = n * avg_deg
  rows = rng.integers(0, n, e).astype(np.int32)
  cols = (rng.zipf(1.3, e) % n).astype(np.int32)
  feat = rng.standard_normal((n, feat_dim)).astype(np.float32)
  order = np.argsort(rows, kind='stable')
  uniq, first_pos = np.unique(rows[order], return_index=True)
  first_nbr = np.arange(n)
  first_nbr[uniq] = cols[order[first_pos]]
  label = (first_nbr % NUM_CLASSES).astype(np.int64)
  return rows, cols, feat, label


def build(args, device):
  """``(dataset, loader, info)``: the hot/cold dataset and the block
  loader over 1% of the nodes (uniform seeds, so batches reach the cold
  tail), as the JAX example builds them; ``info`` holds the split, the
  hot row count and the host build time."""
  import graphlearn_tpu_torch as gtt
  t0 = time.perf_counter()
  rng = np.random.default_rng(0)
  n = args.num_nodes
  rows, cols, feat, label = make_graph(n, args.avg_deg, args.feat_dim, rng)
  feat_gb = feat.nbytes / (1 << 30)
  split = min(1.0, args.hot_gb / feat_gb)
  if split >= 1.0:
    raise ValueError('pick --num-nodes/--hot-gb so the features exceed '
                     'the hot budget')
  ds = gtt.data.Dataset(device=device)
  ds.init_graph(np.stack([rows, cols]), num_nodes=n, graph_mode='HBM')
  ds.init_node_features(feat, sort_func=gtt.data.sort_by_in_degree,
                        split_ratio=split)
  ds.init_node_labels(label)
  seeds = rng.integers(0, n, n // 100)
  ds.node_features.lazy_init()
  loader = gtt.loader.NeighborLoader(
      ds, args.fanout, seeds, batch_size=args.batch_size, shuffle=True,
      drop_last=True, seed=0, dedup='tree', strategy='block',
      to_device=device)
  info = dict(num_nodes=n, feat_gb=feat_gb, split_ratio=split,
              hot_rows=int(n * split), build_s=time.perf_counter() - t0)
  return ds, loader, info


def build_model(args, feat_dim, device, generator):
  """The JAX example's model: hidden 64, 16 classes, one layer per hop,
  the layered segment forward over ``tree_hop_offsets``."""
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import train as train_lib
  no, eo = train_lib.tree_hop_offsets(args.batch_size, args.fanout)
  return gtt.models.GraphSAGE(
      feat_dim, HIDDEN, NUM_CLASSES, num_layers=len(args.fanout),
      hop_node_offsets=no, hop_edge_offsets=eo, device=device,
      generator=generator)


def hit_rate(node_sets, id2index, hot: int) -> float:
  """Share of real lookups (FILL pads left out) that hit the hot prefix."""
  hits = total = 0
  for nd in node_sets:
    ids = nd.cpu().numpy() if hasattr(nd, 'cpu') else np.asarray(nd)
    ids = ids[ids >= 0]
    hits += int((id2index[ids] < hot).sum())
    total += ids.size
  return hits / max(total, 1)


def build_tiered(args, device):
  """``(dataset, loader, info)`` of the three-tier mode, as the JAX
  example's ``main_tiered`` builds them: the same synthetic, its rows
  sorted hot-first by in-degree into a ``TieredFeature`` whose cold tail
  is spilled under ``--spill-dir``, and the tree loader (default hops)
  over 1% of the nodes."""
  import graphlearn_tpu_torch as gtt
  t0 = time.perf_counter()
  rng = np.random.default_rng(0)
  n = args.num_nodes
  rows, cols, feat, label = make_graph(n, args.avg_deg, args.feat_dim, rng)
  feat_gb = feat.nbytes / (1 << 30)
  row_gb = args.feat_dim * 4 / (1 << 30)
  hot = min(n, int(args.hot_gb / row_gb))
  warm = min(n - hot, int(args.warm_gb / row_gb))
  if hot + warm >= n:
    raise ValueError('pick --num-nodes/--hot-gb/--warm-gb so the disk tier '
                     'is non-empty')
  ds = gtt.data.Dataset(device=device)
  ds.init_graph(np.stack([rows, cols]), num_nodes=n, graph_mode='HBM')
  reordered, id2idx = gtt.data.sort_by_in_degree(feat, hot / n,
                                                 ds.graph.topo)
  del feat
  ds.node_features = gtt.storage.TieredFeature(
      reordered, hot_rows=hot, warm_rows=warm, id2index=id2idx,
      spill_dir=args.spill_dir, device=device)
  del reordered
  ds.init_node_labels(label)
  loader = gtt.loader.NeighborLoader(
      ds, args.fanout, rng.integers(0, n, n // 100),
      batch_size=args.batch_size, shuffle=True, drop_last=True, seed=0,
      dedup='tree', to_device=device)
  info = dict(num_nodes=n, feat_gb=feat_gb, build_s=time.perf_counter() - t0)
  return ds, loader, info


def run_tiered(args, params=None, on_trainer=None):
  """The three-tier mode: one reactive batch (the JAX example's template
  batch), then one ``TieredScanTrainer`` epoch of at most ``--steps``
  steps. Returns ``(result, losses)``. ``on_trainer(trainer)`` is called
  before the epoch (to attach hooks, a checkpointer)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch import metrics
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  c0 = metrics.default_registry().counters('storage.')
  ds, loader, info = build_tiered(args, device)
  occ = ds.node_features.tier_occupancy()
  print(f'# features {info["feat_gb"]:.1f} GB -> tiers hot={occ["hot"]} '
        f'warm={occ["warm"]} disk={occ["disk"]} rows; built in '
        f'{info["build_s"]:.1f}s', flush=True)
  # the model: hidden 64, 16 classes, one layer per hop, the segment
  # forward (the JAX example's GraphSAGE without hop offsets)
  model = gtt.models.GraphSAGE(
      args.feat_dim, HIDDEN, NUM_CLASSES, num_layers=len(args.fanout),
      device=device, generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  model.train()
  next(iter(loader))   # one reactive tiered batch, as JAX's template
  state = train_lib.create_train_state(model, lr=args.lr)
  trainer = gtt.storage.TieredScanTrainer(loader, model, NUM_CLASSES,
                                          chunk_size=args.chunk_size)
  if on_trainer is not None:
    on_trainer(trainer)
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  sync()
  t0 = time.perf_counter()
  try:
    state, losses, _ = trainer.run_epoch(state, max_steps=args.steps)
    sync()
    dt = time.perf_counter() - t0
  finally:
    trainer.close()
  c1 = metrics.default_registry().counters('storage.')
  staged = c1.get('storage.staged_rows', 0) - c0.get('storage.staged_rows', 0)
  missed = (c1.get('storage.prefetch_miss', 0) -
            c0.get('storage.prefetch_miss', 0))
  losses = losses.cpu().tolist()
  result = {
      'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
      'num_nodes': info['num_nodes'], 'feat_gb': round(info['feat_gb'], 2),
      'tiers': occ, 'steps': len(losses),
      'final_loss': round(losses[-1], 4), 'epoch_wall_s': round(dt, 3),
      'ms_per_step': round(dt * 1e3 / max(len(losses), 1), 3),
      'staged_rows': int(staged), 'prefetch_miss': int(missed),
      'prefetch_hit_rate': round(staged / max(staged + missed, 1), 4),
      'plan': trainer.last_plan.stats(),
      'timing': 'wall, host clock around the epoch ending in a '
                'device synchronize (the plan prologue included)',
  }
  return result, losses


def run(args, params=None):
  """Train as the JAX example does: the loader's first batch takes one
  (warm-up) step, then ``--steps`` timed steps. Returns ``(result,
  losses)`` with every step's loss (the warm-up's first) as floats.
  ``params``: flax parameters to start from (numpy leaves; default:
  torch's initialisation from ``--seed``). With ``--spill-dir`` this is
  the three-tier mode (:func:`run_tiered`)."""
  import torch
  if args.spill_dir is not None:
    return run_tiered(args, params)

  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  ds, loader, info = build(args, device)
  model = build_model(args, args.feat_dim, device,
                      torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  model.train()
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
  it = iter(loader)
  state, loss0, _ = train_step(state, train_lib.batch_to_dict(next(it)))
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  sync()
  losses, node_sets = [], []
  t0 = time.perf_counter()
  for i, batch in enumerate(it):
    if i >= args.steps:
      break
    state, loss, _ = train_step(state, train_lib.batch_to_dict(batch))
    losses.append(loss)
    node_sets.append(batch.node)
  sync()
  dt = time.perf_counter() - t0
  losses = [float(loss0)] + [float(v) for v in losses]
  result = {
      'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
      'num_nodes': info['num_nodes'], 'feat_gb': round(info['feat_gb'], 2),
      'split_ratio': round(info['split_ratio'], 3),
      'hot_hit_rate': round(hit_rate(node_sets, ds.node_features.id2index,
                                     info['hot_rows']), 3),
      'steps': len(losses) - 1,
      'first_loss': round(losses[0], 4), 'final_loss': round(losses[-1], 4),
      'secs_per_step_wall': round(dt / max(len(losses) - 1, 1), 4),
      'build_s': round(info['build_s'], 1),
  }
  return result, losses


def parser():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--num-nodes', type=int, default=10_000_000)
  ap.add_argument('--avg-deg', type=int, default=8)
  ap.add_argument('--feat-dim', type=int, default=128)
  ap.add_argument('--hot-gb', type=float, default=2.0,
                  help='device budget for the hot feature prefix')
  ap.add_argument('--steps', type=int, default=8)
  ap.add_argument('--batch-size', type=int, default=256)
  ap.add_argument('--fanout', type=int, nargs='+', default=[5, 5])
  ap.add_argument('--spill-dir', default=None,
                  help='three-tier mode: spill the cold tail to '
                       'memory-mapped chunk files here and run one scanned '
                       'epoch over a TieredFeature (TieredScanTrainer)')
  ap.add_argument('--warm-gb', type=float, default=1.0,
                  help='host-RAM budget for the warm tier (three-tier mode '
                       'only)')
  ap.add_argument('--chunk-size', type=int, default=8,
                  help='scan chunk K (three-tier mode only)')
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
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
