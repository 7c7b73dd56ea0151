"""Train GraphSAGE from tables, with the port.

The port of ``examples/train_from_tables.py``: a small tabular dataset
(20,000 nodes; three edge tables, one ``.npy`` ``[2, E]`` per shard, and
three node tables, ``.npz`` with ids, feats and labels) is written to a
temporary directory, read back by ``data.TableDataset`` on its reader
threads, and trained on: ``NeighborLoader([10, 5])`` tree batches of 256,
GraphSAGE hidden 64 with the layered ``tree_dense`` forward, Adam at
3e-3, two epochs. ``TableDataset`` keeps every feature row on the host by
default (``split_ratio=0.0``, as in the JAX package), so on the card every
batch's features come through the hot/cold kernel, all cold.

Run on the card:  python -m graphlearn_tpu_torch.examples.train_from_tables
On the CPU:       ... --device cpu
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np

FANOUTS = [10, 5]
BATCH = 256
HIDDEN = 64


def write_tables(root, rng, n=20_000, shards=3):
  """The JAX example's tables (its lines 29-53), draw for draw:
  ``(edge_tables, node_tables, n, num_classes)``."""
  ncls = 8
  comm = (np.arange(n) % ncls).astype(np.int64)
  e = n * 10
  rows = rng.integers(0, n, e)
  intra = rng.random(e) < 0.85
  cols = np.where(intra, (rows + ncls * rng.integers(0, n // ncls, e)) % n,
                  rng.integers(0, n, e))
  edge_tables = []
  for s in range(shards):
    path = os.path.join(root, f'edges_{s}.npy')
    np.save(path, np.stack([rows[s::shards], cols[s::shards]]))
    edge_tables.append(path)
  feats = (comm[:, None] == np.arange(32) % ncls) * 1.0 + \
      0.5 * rng.standard_normal((n, 32))
  node_tables = []
  for s in range(shards):
    ids = np.arange(s, n, shards)
    path = os.path.join(root, f'nodes_{s}.npz')
    np.savez(path, ids=ids, feats=feats[ids].astype(np.float32),
             labels=comm[ids])
    node_tables.append(path)
  return edge_tables, node_tables, n, ncls


def load(device):
  """``(dataset, n, num_classes, load seconds)``: the tables written and
  read back through ``TableDataset`` (graph on the device, features on
  the host)."""
  import graphlearn_tpu_torch as gtt
  rng = np.random.default_rng(0)
  with tempfile.TemporaryDirectory() as root:
    t0 = time.perf_counter()
    edge_tables, node_tables, n, ncls = write_tables(root, rng)
    ds = gtt.data.TableDataset(edge_tables=edge_tables,
                               node_tables=node_tables, graph_mode='HBM',
                               num_threads=4, device=device)
    ds.node_features.lazy_init()
    return ds, n, ncls, time.perf_counter() - t0


def make_loader(ds, n, device):
  import graphlearn_tpu_torch as gtt
  return gtt.loader.NeighborLoader(
      ds, FANOUTS, np.arange(int(n * 0.5)), batch_size=BATCH, shuffle=True,
      drop_last=True, seed=0, dedup='tree', to_device=device)


def build_model(feat_dim, ncls, device, generator):
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import train as train_lib
  no, eo = train_lib.tree_hop_offsets(BATCH, FANOUTS)
  return gtt.models.GraphSAGE(
      feat_dim, HIDDEN, ncls, num_layers=2, hop_node_offsets=no,
      hop_edge_offsets=eo, tree_dense=True, fanouts=FANOUTS, device=device,
      generator=generator)


def run(args, params=None):
  """Train as the JAX example does; returns ``(result, losses)`` with the
  per-step losses as floats. ``params``: flax parameters to start from
  (numpy leaves; default: torch's initialisation from ``--seed``)."""
  import torch

  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  ds, n, ncls, load_s = load(device)
  loader = make_loader(ds, n, device)
  model = build_model(ds.node_features.shape[1], ncls, device,
                      torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params))
  model.train()
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  step, _ = train_lib.make_train_step(model, ncls)
  losses, accs = [], []
  for _ in range(args.epochs):
    for b in loader:
      state, loss, acc = step(state, train_lib.batch_to_dict(b))
      losses.append(loss)
      accs.append(acc)
  losses = [float(v) for v in losses]
  result = {
      'device': (torch.cuda.get_device_name(device)
                 if device.type == 'cuda' else 'cpu'),
      'source': '3 edge + 3 node tables',
      'num_nodes': n, 'table_load_s': round(load_s, 2),
      'first_loss': round(losses[0], 4), 'final_loss': round(losses[-1], 4),
      'final_train_acc': round(float(accs[-1]), 4),
  }
  return result, losses


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
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
