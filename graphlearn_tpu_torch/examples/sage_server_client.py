"""GraphSAGE in server-client mode, on the port.

Counterpart of ``examples/distributed/server_client/sage_server.py`` and
``sage_client.py``, as one module with two subcommands. The ``server``
owns the JAX example's graph (a uniform random graph from
``default_rng(0)``: 20,000 nodes, average degree 12, 64 float32 features,
16 label classes) on the card, runs sampling producers for the clients
that ask, and streams their batches over the RPC; start it first, it
prints its endpoint. The ``client`` pulls ``[10, 5]`` batches of 128
seeds through a ``RemoteDistNeighborLoader`` (one sampling worker on the
server, two fetches in flight) and trains ``GraphSAGE`` (hidden 128, 2
layers, Adam at 3e-3) on them; its last line is the JAX client's JSON
line (batches, first and final loss). The client's ``exit`` stops the
server.

Run on the card:   python -m graphlearn_tpu_torch.examples.sage_server_client server --port 18777
                   python -m graphlearn_tpu_torch.examples.sage_server_client client --port 18777
On the CPU:        ... server --device cpu --num-nodes 2000
                   ... client --device cpu --num-nodes 2000
"""
import argparse
import json

import numpy as np

FEAT_DIM = 64
NUM_CLASSES = 16
FANOUTS = [10, 5]


def make_data(num_nodes: int, avg_deg: int):
  """The JAX server's draws: ``(edge_index [2, n * avg_deg], feats [n,
  64] float32, labels [n] int64)``."""
  rng = np.random.default_rng(0)
  n, e = num_nodes, num_nodes * avg_deg
  rows = rng.integers(0, n, e)
  cols = rng.integers(0, n, e)
  feat = rng.standard_normal((n, FEAT_DIM)).astype(np.float32)
  labels = rng.integers(0, NUM_CLASSES, n)
  return np.stack([rows, cols]), feat, labels


def build_dataset(num_nodes: int, avg_deg: int, device):
  """The server's ``Dataset`` on ``device``."""
  import graphlearn_tpu_torch as gtt
  ei, feat, labels = make_data(num_nodes, avg_deg)
  ds = gtt.data.Dataset(device=device)
  ds.init_graph(ei, num_nodes=num_nodes)
  ds.init_node_features(feat)
  ds.init_node_labels(labels)
  return ds


def run_server(args, on_ready=None):
  """Serve until a client calls ``exit``. ``on_ready((host, port))`` is
  called once the endpoint listens."""
  import graphlearn_tpu_torch as gtt
  ds = build_dataset(args.num_nodes, args.avg_deg, args.device)
  host, port = gtt.distributed.init_server(
      num_servers=1, num_clients=args.num_clients, server_rank=0,
      dataset=ds, server_client_master_port=args.port)
  print(f'server listening on {host}:{port}', flush=True)
  if on_ready is not None:
    on_ready((host, port))
  gtt.distributed.wait_and_shutdown_server()
  print('server exited', flush=True)


def run_client(args, params=None):
  """Train as the JAX client does; returns ``(result, losses, first)``:
  the JSON result, the per-step losses as floats and the first trained
  batch. ``params``: flax GraphSAGE parameters to start from (numpy
  leaves; default: torch's initialisation from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  gdist = gtt.distributed
  gdist.init_client(num_servers=1, num_clients=1, client_rank=0,
                    server_addrs=[(args.host, args.port)])
  try:
    opts = gdist.RemoteDistSamplingWorkerOptions(
        server_rank=0, num_workers=1, prefetch_size=2)
    loader = gdist.RemoteDistNeighborLoader(
        FANOUTS, np.arange(args.num_nodes), batch_size=args.batch_size,
        collect_features=True, worker_options=opts, seed=0, device=device)
    try:
      model = gtt.models.GraphSAGE(
          FEAT_DIM, 128, NUM_CLASSES, num_layers=2, device=device,
          generator=torch.Generator().manual_seed(args.seed))
      if params is not None:
        model.load_state_dict(convert.params_from_flax(params, model))
      # the JAX client initialises its model from one batch of a first
      # epoch it then leaves: drawing it keeps the two streams in step
      next(iter(loader))
      state = train_lib.create_train_state(model, lr=3e-3)
      train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
      losses, first = [], None
      for _ in range(args.epochs):
        for batch in loader:
          if first is None:
            first = batch
          state, loss, _ = train_step(state, train_lib.batch_to_dict(batch))
          losses.append(loss)
    finally:
      loader.shutdown()
  finally:
    gdist.shutdown_client()
  losses = [float(v) for v in losses]     # the host reads: after training
  result = {'batches': len(losses), 'first_loss': round(losses[0], 4),
            'final_loss': round(losses[-1], 4)}
  return result, losses, first


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('role', choices=('server', 'client'))
  ap.add_argument('--host', default='127.0.0.1')
  ap.add_argument('--port', type=int, default=18777)
  ap.add_argument('--num-nodes', type=int, default=20_000)
  ap.add_argument('--avg-deg', type=int, default=12)
  ap.add_argument('--num-clients', type=int, default=1)
  ap.add_argument('--epochs', type=int, default=1)
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  args = ap.parse_args(argv)
  if args.role == 'server':
    run_server(args)
    return None
  result, _, _ = run_client(args)
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
