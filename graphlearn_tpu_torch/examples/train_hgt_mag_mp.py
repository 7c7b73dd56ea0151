"""HGT on the MAG-shaped synthetic through the mp loader, on the port.

Counterpart of ``examples/hetero/train_hgt_mag_mp.py``: the graph and
model of ``train_hgt_mag`` (60,000 papers, 7 edge types, ``[10, 10]``
per edge type at batch 512, HGT hidden 64 with 4 heads, 2 layers, Adam
at 3e-3), but the batches come from sampling worker PROCESSES feeding a
shared-memory channel (``MpDistNeighborLoader`` ->
``DistMpSamplingProducer`` -> ``ShmChannel``). The workers sample on the
dataset's device (the card) with the exact-dedup typed engine, so the
model is the merge-dense HGT (``HGT(merge_dense=True)`` over the
hierarchical layout of ``sampler.hetero_tree_blocks``). The last line is
the JAX example's JSON line (first and final loss, test accuracy, mean
epoch wall time).

Run on the card:   python -m graphlearn_tpu_torch.examples.train_hgt_mag_mp
On the CPU:        ... --device cpu --n-paper 3000 --batch-size 64
"""
import argparse
import json
import time

import numpy as np

from .train_hgt_mag import (FANOUTS, NUM_CLASSES, build_dataset,
                            build_model)


def run(args, params=None):
  """Train as the JAX example does; returns ``(result, losses, first)``
  with the per-step losses as floats and the first trained batch.
  ``params``: flax HGT parameters to start from (numpy leaves; default:
  torch's initialisation from ``--seed``)."""
  import torch

  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  ds = build_dataset(args.n_paper, device)
  n_tr = int(args.n_paper * 0.2)
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, FANOUTS, ('paper', np.arange(n_tr)), batch_size=args.batch_size,
      shuffle=True, drop_last=True, num_workers=args.num_workers, seed=0,
      channel_size=args.channel_size)
  test_loader = None
  try:
    test_loader = gtt.distributed.MpDistNeighborLoader(
        ds, FANOUTS, ('paper', np.arange(n_tr, int(args.n_paper * 0.25))),
        batch_size=args.batch_size, shuffle=False,
        num_workers=args.num_workers, seed=1,
        channel_size=args.channel_size)
    model = build_model(args.batch_size, args.hidden, args.heads, device,
                        mode='merge_dense',
                        generator=torch.Generator().manual_seed(args.seed))
    if params is not None:
      model.load_state_dict(convert.params_from_flax(params, model))
    state = train_lib.create_train_state(model, lr=args.lr)
    train_step, _ = train_lib.make_train_step(model, NUM_CLASSES)
    eval_counts = train_lib.make_eval_counts(model)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    losses, epoch_times, first = [], [], None
    for epoch in range(args.epochs):
      t0 = time.perf_counter()
      for batch in loader:
        if first is None:
          first = batch
        state, loss, _ = train_step(state, train_lib.batch_to_dict(batch))
        losses.append(loss)
      sync()
      if epoch:    # the JAX example times every epoch but the first
        epoch_times.append(time.perf_counter() - t0)
    correct = total = 0
    model.eval()
    for batch in test_loader:
      c, t = eval_counts(train_lib.batch_to_dict(batch))
      correct, total = correct + c, total + t
  finally:
    loader.shutdown()
    if test_loader is not None:
      test_loader.shutdown()
  losses = [float(v) for v in losses]      # the host reads: after training
  result = {
      'model': 'HGT (mp loader)', 'n_paper': args.n_paper,
      'epochs': args.epochs, 'num_workers': args.num_workers,
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'test_acc': round(float(correct) / max(float(total), 1.0), 4),
      'epoch_time_s_wall': (round(float(np.mean(epoch_times)), 3)
                            if epoch_times else None),
  }
  return result, losses, first


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--n-paper', type=int, default=60_000)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--heads', type=int, default=4)
  ap.add_argument('--lr', type=float, default=3e-3)
  ap.add_argument('--num-workers', type=int, default=2)
  ap.add_argument('--channel-size', type=int, default=1 << 26,
                  help='bytes of the shared-memory ring')
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  result, _, _ = run(ap.parse_args(argv))
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
