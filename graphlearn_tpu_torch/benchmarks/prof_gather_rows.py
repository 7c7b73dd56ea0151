"""Probe suite: K1, the row gather (``csrc/gather_rows.cu``), against other
builds of the same two entries, in turns on one card.

Each ``--against FILE.cu`` (another version of ``gather_rows.cu``: its
parent commit's, a variant) is built with the port's nvcc flags into a
library of its own, its includes looked up beside it and then in
``csrc/``. A build is swapped in for the port's own library while its
turn runs, so the wrappers (``ops.gather_rows_hbm``,
``ops.gather_rows_sharded``) and a captured trainer launch it as they
would the port's. The turns go A, B, B, A: the builds named by
``--against`` in order, the port's build twice, the ``--against`` builds
in reverse order. Every turn of every case is held bit for bit against
``ops.gather_rows_plain`` (``gather_rows_sharded_plain`` for the sharded
entry).

Cases, over the synthetic products graph of ``chip_smoke.py`` (1M nodes,
25M edges, ``[1M, 100]`` float32 features from seed 0):

- ``kernel``: 937,984 ids drawn as ``chip_smoke.py``'s kernel phase draws
  them (uniform, every 97th a FILL slot, some out of range, an eighth
  repeated) over ``f32[1M,100]``, ``bf16[1M,100]`` and ``f32[1M,128]``;
- ``tree``: the node ids of one ``[15, 10, 5] x 1,024`` tree batch (FILL
  read as row 0) over ``f32[1M,100]``;
- ``sharded``: the same ids through the sharded entry over the table held
  as two row blocks on the card (a group naming the card twice);
- ``scan`` (with ``--scan``): a captured ``ScanTrainer``'s ms/step, tree
  and calibrated merge, 16 steps at K = 8 after a warm-up epoch (host
  clock to a synchronise, the median of ``--epochs`` epochs).

Each case's ms is the median of 20 calls, each queued behind a spin
kernel between two CUDA events (``chip_smoke.py``'s device ms). Beside it
stand the bound (the ids, each distinct row and the output, once, over
3.35 TB/s), the every-slot floor (the ids plus every slot's row read and
written: what a gather that does not dedup cannot beat) and the card's
own copy of the output's bytes (``Tensor.copy_``, timed the same way):
the rate such bytes move at on this card.

Run on the card:
  python -m graphlearn_tpu_torch.benchmarks.prof_gather_rows \\
      --against build/k1_parent/gather_rows.cu [--scan]
One JSON line at the end: per case and turn the device ms and exactness,
the bounds, the port's launch shape, the card's name and power limit.
"""
import contextlib
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import ops
from ..ops import kernels
from .common import H100_BYTES_PER_S, SPIN_CYCLES, require_card

NODES, DEGREE, WIDTH, CLASSES = 1_000_000, 25, 100, 47
FANOUTS, BATCH, HIDDEN = [15, 10, 5], 1024, 256
SLOTS = BATCH * (1 + 15 + 150 + 750)   # a tree batch's node slots
REPS = 20
SCAN_STEPS, SCAN_CHUNK = 16, 8


def build(source: Path) -> Path:
  """``source`` built into its own library beside the port's."""
  h = hashlib.sha256(source.read_bytes())
  for extra in sorted(kernels.CSRC.glob('*.cuh')):
    h.update(extra.read_bytes())
  out = kernels.BUILD_DIR / f'against-{h.hexdigest()[:16]}.so'
  if not out.exists():
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, '-I', str(kernels.CSRC),
         '-o', str(out), str(source)], capture_output=True, text=True)
    out.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
      raise RuntimeError(f'{source}: nvcc exited {proc.returncode}\n'
                         f'{proc.stdout}{proc.stderr}')
  return out


def load(path: Path):
  """The library at ``path`` with the port's argtypes for the entries it
  has."""
  handle = ctypes.CDLL(str(path))
  for fn, (argtypes, restype) in kernels.SOURCES['gather_rows'][1].items():
    if hasattr(handle, fn):
      getattr(handle, fn).argtypes = argtypes
      getattr(handle, fn).restype = restype
  return handle


@contextlib.contextmanager
def using(handle):
  """The wrappers launch ``handle``'s entries inside the block."""
  kernels.lib('gather_rows')
  saved = kernels._libs['gather_rows']
  kernels._libs['gather_rows'] = handle
  try:
    yield
  finally:
    kernels._libs['gather_rows'] = saved


def queued_ms(fn, reps: int = REPS) -> float:
  """Median device ms of ``fn``: each call queued behind a spin kernel,
  between two CUDA events, after one warm-up call."""
  fn()
  times = []
  for _ in range(reps):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES // 2)
    a.record()
    fn()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
  return float(np.median(times))


def kernel_ids(n: int, gen: torch.Generator) -> torch.Tensor:
  """``chip_smoke.py``'s kernel-phase ids (int32)."""
  ids = torch.randint(0, n, (SLOTS,), generator=gen, dtype=torch.int64)
  ids[::97] = -1
  ids[5::211] = n + 5
  ids[7::389] = -12345
  ids[SLOTS // 2:SLOTS // 2 + SLOTS // 8] = ids[:SLOTS // 8].clone()
  return ids.to(torch.int32)


def bounds(ids: torch.Tensor, n_rows: int, row_bytes: int) -> dict:
  """The bound (distinct rows read once) and the every-slot floor, ms."""
  slots = ids.numel()
  uniq = int(torch.unique(ids.clamp(0, n_rows - 1)).numel())
  id_bytes = slots * ids.element_size()
  return dict(unique_rows=uniq,
              bound_ms=(id_bytes + (uniq + slots) * row_bytes) /
              H100_BYTES_PER_S * 1e3,
              every_slot_ms=(id_bytes + 2 * slots * row_bytes) /
              H100_BYTES_PER_S * 1e3)


def make_graph(seed: int = 0):
  """``chip_smoke.py``'s synthetic graph: half the edges uniform, half
  into a zipf(1.5) head; features and labels from the same stream."""
  rng = np.random.default_rng(seed)
  e = NODES * DEGREE
  rows = rng.integers(0, NODES, e)
  cols = np.empty(e, np.int64)
  half = e // 2
  cols[:half] = rng.integers(0, NODES, half)
  cols[half:] = rng.zipf(1.5, e - half) % NODES
  feats = rng.standard_normal((NODES, WIDTH), dtype=np.float32)
  labels = rng.integers(0, CLASSES, NODES).astype(np.int32)
  return np.stack([rows, cols]), feats, labels


def turns(builds: dict) -> list:
  """The turn order: the ``--against`` builds, the port's twice, back."""
  others = [k for k in builds if k != 'port']
  return others + ['port', 'port'] + others[::-1]


def gather_cases(builds, order, tables, ids_by_case, shards, ptrs):
  """Every case in every turn: ``{case: {ms: {build: [ms...]}, exact}}``."""
  out = {}
  for case, (table_name, ids, entry) in ids_by_case.items():
    table = tables[table_name]
    if entry == 'sharded':
      def run():
        return ops.gather_rows_sharded(shards, ptrs, ids)
      want = ops.gather_rows_sharded_plain(shards, ids)
    else:
      def run():
        return ops.gather_rows_hbm(table, ids)
      want = ops.gather_rows_plain(table, ids)
    rec = dict(table=table_name, entry=entry, ids=ids.numel(),
               ms={k: [] for k in builds}, exact={k: True for k in builds},
               **bounds(ids, table.shape[0],
                        table.shape[1] * table.element_size()))
    # the card's own copy of the output's bytes (read once, written once):
    # the rate a gather's every-slot bytes could move at
    copy = torch.empty_like(want)
    rec['copy_ms'] = queued_ms(lambda: copy.copy_(want))
    rec['copy_gb_s'] = 2 * want.numel() * want.element_size() / (
        rec['copy_ms'] * 1e6)
    del copy
    for name in order:
      with using(builds[name]):
        got = run()
        torch.cuda.synchronize()
        rec['exact'][name] &= bool(torch.equal(got, want))
        rec['ms'][name].append(queued_ms(run))
    if entry == 'one':
      rec['shape'] = ops.gather.gather_rows_shape(table, ids)
    out[case] = rec
  return out


def scan_cases(gtt, ds, device, builds, order, epochs):
  """A captured ``ScanTrainer``'s ms/step per mode and build."""
  from ..models import train
  pool = np.random.default_rng(1).permutation(NODES)[:BATCH * SCAN_STEPS]
  out = {}
  caps = 'auto'
  for mode in ('tree', 'merge'):
    rec = {k: [] for k in builds}
    for name in order:
      if mode == 'tree':
        loader = gtt.loader.NeighborLoader(
            ds, FANOUTS, pool, batch_size=BATCH, shuffle=False, seed=0,
            dedup='tree', device=device)
        no, eo = train.tree_hop_offsets(BATCH, FANOUTS)
      else:
        loader = gtt.loader.NeighborLoader(
            ds, FANOUTS, pool, batch_size=BATCH, shuffle=False, seed=0,
            dedup='auto', frontier_caps=caps, overflow_policy='raise',
            device=device)
        caps = list(loader.sampler.frontier_caps)
        no, eo = train.merge_hop_offsets(BATCH, FANOUTS, frontier_caps=caps)
      model = gtt.models.GraphSAGE(
          WIDTH, HIDDEN, CLASSES, num_layers=len(FANOUTS),
          hop_node_offsets=no, hop_edge_offsets=eo,
          tree_dense=mode == 'tree', merge_dense=mode == 'merge',
          fanouts=FANOUTS, device=device,
          generator=torch.Generator().manual_seed(0))
      model.train()
      with using(builds[name]):
        tr = gtt.loader.ScanTrainer(loader, model, CLASSES,
                                    chunk_size=SCAN_CHUNK, capture=True)
        state = train.create_train_state(model, lr=3e-3)
        state, _, _ = tr.run_epoch(state)      # the eager chunk, captures
        torch.cuda.synchronize()
        per = []
        for _ in range(epochs):
          t0 = time.perf_counter()
          state, losses, _ = tr.run_epoch(state)
          torch.cuda.synchronize()
          per.append((time.perf_counter() - t0) * 1e3 / SCAN_STEPS)
        assert bool(torch.isfinite(losses).all()), (mode, name)
      rec[name].append(float(np.median(per)))
      del tr, state, model, loader
    out[mode] = rec
  return out


def card() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()


def main(argv=None):
  import argparse

  import graphlearn_tpu_torch as gtt
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--against', action='append', default=[], metavar='CU',
                  help='another gather_rows.cu to time in turns with the '
                  "port's (repeatable)")
  ap.add_argument('--scan', action='store_true',
                  help="also time captured ScanTrainer epochs (tree, merge)")
  ap.add_argument('--epochs', type=int, default=3,
                  help='timed ScanTrainer epochs a turn (median)')
  args = ap.parse_args(argv)
  device = require_card()
  smi = card()
  t0 = time.perf_counter()
  builds = {'port': kernels.lib('gather_rows')}
  for path in args.against:
    builds[path] = load(build(Path(path)))
  order = turns(builds)
  ei, feats, labels = make_graph()
  topo = gtt.data.Topology(ei, num_nodes=NODES)
  ds = gtt.data.Dataset(device=device)
  ds.graph = gtt.data.Graph(topo, device=device)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  gen = torch.Generator().manual_seed(0)
  f32 = ds.node_features.device_table()[0]
  tables = {'f32[1M,100]': f32, 'bf16[1M,100]': f32.to(torch.bfloat16),
            'f32[1M,128]': torch.randn((NODES, 128), generator=gen).to(
                device)}
  ids = kernel_ids(NODES, gen).to(device)
  seeds = np.random.default_rng(1).permutation(NODES)[:BATCH]
  loader = gtt.loader.NeighborLoader(ds, FANOUTS, seeds, batch_size=BATCH,
                                     shuffle=False, seed=0, dedup='tree',
                                     device=device)
  node = loader.sampler.sample_from_nodes(
      gtt.sampler.NodeSamplerInput(seeds), batch_cap=BATCH).node
  tree = torch.where(node < 0, 0, node).contiguous()
  half = NODES // 2
  shards = [f32[:half].clone(), f32[half:].clone()]
  ptrs = ops.peer.pointer_table(shards, device)
  cases = {f'kernel {name}': (name, ids, 'one') for name in tables}
  cases['tree f32[1M,100]'] = ('f32[1M,100]', tree, 'one')
  cases['sharded f32[1M,100]'] = ('f32[1M,100]', tree, 'sharded')
  recs = gather_cases(builds, order, tables, cases, shards, ptrs)
  for case, r in recs.items():
    print(f'# {case}: ids={r["ids"]} ' + ' '.join(
        f'{Path(k).parent.name or k}=' + '/'.join(f'{t:.4f}' for t in v)
        for k, v in r['ms'].items()) +
        f' ms; exact {r["exact"]}; bound {r["bound_ms"]:.4f}, every-slot '
        f'floor {r["every_slot_ms"]:.4f}; the output\'s copy '
        f'{r["copy_ms"]:.4f} ms ({r["copy_gb_s"]:.0f} GB/s); shape '
        f'{r.get("shape")} on {smi}',
        flush=True)
  scan = scan_cases(gtt, ds, device, builds, order, args.epochs) if args.scan \
      else None
  if scan:
    for mode, r in scan.items():
      print(f'# captured ScanTrainer {mode} ms/step: ' + ' '.join(
          f'{Path(k).parent.name or k}=' + '/'.join(f'{t:.3f}' for t in v)
          for k, v in r.items()) + f' on {smi}', flush=True)
  assert all(all(r['exact'].values()) for r in recs.values()), recs
  print(json.dumps({'prof_gather_rows': recs, 'scan': scan, 'order': order,
                    'card': smi, 'seconds': time.perf_counter() - t0}),
        flush=True)


if __name__ == '__main__':
  main()
