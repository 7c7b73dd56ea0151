"""A feature store shared with worker processes, on the port.

The port of ``examples/feature_mp.py``: one ``Feature`` (hot/cold split
by in-degree, the ``id2index`` reorder) is handed to two worker
processes, and every worker must gather identical, correct rows. The
handle (``Feature.share_ipc``) goes to each worker through
``torch.multiprocessing`` (spawn): on a card the device prefix travels as
a CUDA IPC handle and the host tail in shared memory, which the worker
maps for its own card again (``Feature.from_ipc_handle``).

Run on the card:  python -m graphlearn_tpu_torch.examples.feature_mp
On the CPU:       ... --device cpu
"""
import argparse
import gc

import numpy as np

WORLD_SIZE = 2
ROWS = 128
WIDTH = 128


def worker(rank, box, q):
  """``box`` holds the store's handle in a list: the worker empties it
  when it is done, because the ``Process`` object keeps its arguments
  until the process ends, and a CUDA IPC handle still referenced then is
  never released to the producer (torch reports at the producer's exit
  that it ended before all shared CUDA tensors were released)."""
  feature = None
  try:
    import graphlearn_tpu_torch as gtt
    feature = gtt.data.Feature.from_ipc_handle(box[0])
    assert list(feature.shape) == [ROWS * 3, WIDTH]
    # ids over all three value blocks (the JAX example's lines 31-36)
    ids = np.array([10, 20, 200, 210, 300, 310], np.int64)
    got = feature[ids].cpu().numpy()
    want = np.concatenate([np.ones((2, WIDTH), np.float32) * v
                           for v in (1.0, 2.0, 3.0)])
    if not np.array_equal(got, want):
      raise AssertionError(f'worker {rank}: rows differ')
    q.put((rank, 'ok'))
  except Exception as e:  # report the worker's failure to the parent
    q.put((rank, f'{type(e).__name__}: {e}'))
  finally:
    box.clear()
    del feature
    gc.collect()


def build_feature(device):
  """The JAX example's store: rows of 1, 2 and 3 in three blocks of 128,
  reordered by the in-degree of a seeded graph, split 0.8."""
  import graphlearn_tpu_torch as gtt
  attr = np.ones((ROWS, WIDTH), np.float32)
  tensor = np.concatenate([attr, attr * 2, attr * 3])
  rng = np.random.default_rng(0)
  n = ROWS * 3
  rows = np.concatenate([np.arange(n), rng.integers(0, 128, n),
                         rng.integers(0, 256, n)])
  cols = rng.integers(0, n, rows.shape[0])
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=n)
  split_ratio = 0.8
  reordered, id2index = gtt.data.sort_by_in_degree(tensor, split_ratio, topo)
  return gtt.data.Feature(reordered, split_ratio=split_ratio,
                          id2index=id2index, device=device)


def run(device=None, world_size=WORLD_SIZE, timeout=120):
  """Spawn ``world_size`` workers on the store's handle; returns their
  ``[(rank, status)]`` sorted by rank (status 'ok' or the failure)."""
  import torch.multiprocessing as mp

  from graphlearn_tpu_torch.utils import resolve_device
  feature = build_feature(resolve_device(device))
  handle = feature.share_ipc()
  ctx = mp.get_context('spawn')
  q = ctx.Queue()
  procs = [ctx.Process(target=worker, args=(r, [handle], q))
           for r in range(world_size)]
  for p in procs:
    p.start()
  try:
    results = [q.get(timeout=timeout) for _ in procs]
  finally:
    for p in procs:
      p.join(timeout)
      if p.is_alive():
        p.kill()
        p.join()
  return sorted(results)


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  results = run(ap.parse_args(argv).device)
  for rank, status in results:
    print(f'worker {rank}: {status}')
  if not all(s == 'ok' for _, s in results):
    raise SystemExit(f'feature_mp failed: {results}')
  print('feature_mp OK')


if __name__ == '__main__':
  main()
