"""Probe suite: how fast does the card read rows of mapped host memory?

The hot/cold gather (``csrc/gather_unified.cu``) reads each distinct cold
row of a lookup over PCIe from the store's mapped host tail. This suite
times ``uva_read_probe.cu`` on the same kind of memory
(``cudaHostRegister``, mapped, read-only where offered) and on the
distinct cold rows of a products tree batch at split 0.25 (88,431 of a
750,000-row tail), moved five ways:

- the copy engine: ``cudaMemcpyAsync`` of as many contiguous bytes (the
  pinned rate);
- one warp per row with 16-byte loads (the gather's route);
- each row one bulk copy (``cp.async.bulk`` on an mbarrier) through
  shared memory;
- the same bytes read contiguously with 16-byte loads;
- one warp per slot of the batch's ~330,000 cold slots, which name those
  rows several times each: the read pattern of a gather that reads a row
  once per slot naming it.

Rows of 400 bytes (100 float32, the products width) and 512 bytes (128
float32) touch the same number of 128-byte lines, so the pair also tells
a byte-bound read from a request-bound one. Then, on the same host, the
port's hot/cold gather (``ops.gather_rows_unified``) on a batch of that
shape: a ``[1M, 100]`` float32 table at split 0.25, 937,984 ids of which
the ~330,000 cold slots name the 88,431 cold rows as above, checked
against the table and its fetch counter against the distinct cold rows.

Run on the card: python -m graphlearn_tpu_torch.benchmarks.prof_uva
One JSON line: per row width the five device ms (median of 10 runs
between CUDA events), their GB/s, the 128-byte lines the rows touch and
the routes' exactness; the kernel's device ms (20 calls between CUDA
events) and its rate on distinct cold bytes; the card's name and power
limit.
"""
import json
import subprocess

import numpy as np
import torch

from .. import ops
from ..ops import kernels, mapped
from .common import device_ms, require_card

SOURCE = kernels.CSRC.parent / 'benchmarks' / 'uva_read_probe.cu'
ROWS = 88_431          # distinct cold rows of the products batch, split 0.25
SLOTS = 330_000        # its cold slots
COLD_ROWS = 750_000    # the [1M, 100] table's host tail at split 0.25
ROW_BYTES = (400, 512)
TABLE_ROWS, WIDTH, BATCH = 1_000_000, 100, 937_984   # the kernel's case


def build() -> str:
  """The probe's executable, built once into the kernels' build folder."""
  exe = kernels.BUILD_DIR / 'uva_read_probe'
  kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  flags = [f for f in kernels.NVCC_FLAGS if f not in ('-shared', '-Xcompiler',
                                                      '-fPIC')]
  subprocess.run([kernels.nvcc_path(), *flags, '-o', str(exe), str(SOURCE)],
                 check=True, capture_output=True, text=True)
  return str(exe)


def run(rows: int = ROWS, slots: int = SLOTS, cold_rows: int = COLD_ROWS,
        row_bytes=ROW_BYTES) -> list:
  """The probe's records, one a row width, with rates added."""
  out = subprocess.run([build(), str(rows), str(slots), str(cold_rows),
                        *map(str, row_bytes)],
                       check=True, capture_output=True, text=True).stdout
  recs = [json.loads(line) for line in out.splitlines() if line.strip()]
  for r in recs:
    for route in ('copy_engine', 'warp_rows', 'bulk_rows', 'warp_stream'):
      r[f'{route}_gb_s'] = r['bytes'] / (r[f'{route}_ms'] * 1e6)
    r['warp_rows_lines_per_us'] = r['lines'] / (r['warp_rows_ms'] * 1e3)
    r['slots_over_rows'] = r['warp_slots_ms'] / r['warp_rows_ms']
  return recs


def kernel_case(device, seed: int = 0) -> dict:
  """The port's hot/cold gather on a products-shaped batch (module
  docstring): exactness, fetched rows, device ms, GB/s on distinct cold
  bytes."""
  rng = np.random.default_rng(seed)
  hot_rows = TABLE_ROWS - COLD_ROWS
  table = rng.standard_normal((TABLE_ROWS, WIDTH), dtype=np.float32)
  hot = torch.from_numpy(table[:hot_rows]).to(device)
  cold = mapped.empty((COLD_ROWS, WIDTH), torch.float32)
  cold.copy_(torch.from_numpy(table[hot_rows:]))
  mapped.register(cold, device)
  try:
    rows = rng.choice(COLD_ROWS, ROWS, replace=False) + hot_rows
    weight = 1.0 / np.arange(1, ROWS + 1) ** 0.6
    slots = np.concatenate([rows, rng.choice(rows, SLOTS - ROWS,
                                             p=weight / weight.sum())])
    ids = np.concatenate([slots, rng.integers(0, hot_rows, BATCH - SLOTS)])
    rng.shuffle(ids)
    dev_ids = torch.as_tensor(ids).to(device)
    got = ops.gather_rows_unified(hot, cold, dev_ids)
    exact = bool(np.array_equal(got.cpu().numpy(), table[ids]))
    fetched = int(ops.gather.unified_fetches)
    ms = device_ms(lambda: ops.gather_rows_unified(hot, cold, dev_ids),
                   device)
  finally:
    mapped.release(cold)
  return dict(ids=BATCH, cold_slots=SLOTS, distinct_cold_rows=ROWS,
              exact=exact, fetched_rows=fetched, ms=ms,
              cold_gb_s=ROWS * WIDTH * 4 / (ms * 1e6))


def card() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip()


def main(argv=None):
  import argparse
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.parse_args(argv)
  device = require_card()
  smi = card()
  recs = run()
  for r in recs:
    print(f'# {r["row_bytes"]}-byte rows, {r["rows"]} of {r["cold_rows"]} '
          f'({r["bytes"] / 1e6:.1f} MB, {r["lines"]} lines): copy engine '
          f'{r["copy_engine_gb_s"]:.2f} GB/s, warp rows '
          f'{r["warp_rows_gb_s"]:.2f} (exact {r["warp_rows_exact"]}), bulk '
          f'rows {r["bulk_rows_gb_s"]:.2f} (exact {r["bulk_rows_exact"]}), '
          f'warp stream {r["warp_stream_gb_s"]:.2f}; the {r["slots"]} slots '
          f'read slot by slot {r["warp_slots_ms"]:.4f} ms, '
          f'{r["slots_over_rows"]:.2f}x the distinct rows on {smi}')
  kern = kernel_case(device)
  print(f'# the hot/cold gather on {kern["ids"]} ids ({kern["cold_slots"]} '
        f'cold slots over {kern["distinct_cold_rows"]} rows): '
        f'{kern["ms"]:.4f} ms, {kern["cold_gb_s"]:.2f} GB/s on distinct '
        f'cold bytes, fetched {kern["fetched_rows"]}, exact {kern["exact"]} '
        f'on {smi}')
  print(json.dumps({'prof_uva': recs, 'kernel': kern, 'card': smi}),
        flush=True)


if __name__ == '__main__':
  main()
