"""Probe suite: which gather, scatter, sort and copy shapes are fast on
this card?

The port of ``benchmarks/prof_mem.py``: the same operations at the same
sizes, in torch on the card, each timed by CUDA events after warm-up
(``benchmarks.common.device_ms``) and printed as device ms and M
elem/s, and for the row and copy probes GB/s (bytes: every input read
once, every output written once). Probe G, the
TPU suite's Pallas row gather (one grid step per row), is the
``row_gather_probe`` kernel (``csrc/row_gather_probe.cu``, each row one
bulk copy in and one out), held against its plain version before it is
timed and set beside
the row-gather kernel ``gather_rows_hbm`` and ``index_select`` on the
same ids.

Differences from the TPU suite: eager torch has no dead-code
elimination, so no probe reduces its result; a scatter writes into its
table in place (the JAX probe's functional update also copies the
table); probe B's ``[N / 128, 128]`` view pads the 1M-entry table to the
next multiple of 128 (1,000,064), which the JAX reshape cannot do;
``torch.sort`` always returns the sorting indices, so probes E (sort) and
E2 (key + payload sort, the payload being each key's source slot)
differ only in the stable flag; torch indexes with int64 ids.

Run on the card: python -m graphlearn_tpu_torch.benchmarks.prof_mem
"""
import json

import numpy as np
import torch

from .. import ops
from .common import device_ms, print_table, record, require_card

N = 1_000_000        # table entries / rows
B = 768_000          # element gathers and scatters
ROWS = 153_600       # row gathers and scatters (hop 1 x batch 1024 x 15 x 10)
WIDTH = 128          # f32 row width


def run(device, iters: int = 20, shrink: int = 1):
  """Every probe on ``device``; sizes divided by ``shrink`` (a rehearsal
  on the CPU). Returns the probe records."""
  n, b, rows = N // shrink, B // shrink, ROWS // shrink
  rng = np.random.default_rng(0)
  t1d = torch.as_tensor(rng.integers(0, 2 ** 31, n).astype(np.int32)).to(
      device)
  idx = torch.as_tensor(rng.integers(0, n, b).astype(np.int32)).to(device)
  idx64 = idx.long()
  idx_sorted = torch.sort(idx64).values
  out = []
  t = lambda fn: device_ms(fn, device, iters)   # noqa: E731

  out.append(record(f'A scalar gather {b} from [{n}]',
                    t(lambda: t1d[idx64]), elems=b))
  out.append(record(f'A2 scalar gather {b}, sorted ids',
                    t(lambda: t1d[idx_sorted]), elems=b))
  # B: the element gather as a row gather plus a lane select
  pad = -n % 128
  t2d = torch.cat([t1d, t1d.new_zeros(pad)]).view(-1, 128)
  r, lane = idx64 // 128, idx64 % 128

  def via_rows():
    return t2d[r].gather(1, lane[:, None])[:, 0]

  if not torch.equal(via_rows(), t1d[idx64]):
    raise RuntimeError('B: row gather + lane select != element gather')
  out.append(record(f'B row gather [{t2d.shape[0]},128] + lane select {b}',
                    t(via_rows), elems=b))
  # C: feature-style row gather
  feat = torch.as_tensor(rng.standard_normal((n, WIDTH)).astype(
      np.float32)).to(device)
  ridx = torch.as_tensor(rng.integers(0, n, rows).astype(np.int32)).to(
      device)
  ridx64 = ridx.long()
  row_bytes = WIDTH * 4
  uniq = int(torch.unique(ridx64).numel())
  gbytes = rows * 4 + uniq * row_bytes + rows * row_bytes
  out.append(record(f'C row gather {rows} from [{n},128] f32 (indexing)',
                    t(lambda: feat[ridx64]), elems=rows, nbytes=gbytes))
  # D: scatter-set
  vals = torch.arange(b, dtype=torch.int32, device=device)
  tab = t1d.clone()
  out.append(record(f'D scalar scatter {b} into [{n}]',
                    t(lambda: tab.index_put_((idx64,), vals)), elems=b))
  rvals = torch.ones((rows, WIDTH), dtype=torch.float32, device=device)
  ftab = feat.clone()
  out.append(record(f'D2 row scatter {rows} into [{n},128]',
                    t(lambda: ftab.index_put_((ridx64,), rvals)),
                    elems=rows, nbytes=rows * (8 + 2 * row_bytes)))
  del tab, ftab
  # E: sorts
  out.append(record(f'E sort {b} int32', t(lambda: torch.sort(idx)),
                    elems=b))
  out.append(record(f'E2 key+payload sort {b} (payload = source slot)',
                    t(lambda: torch.sort(idx, stable=True)), elems=b))
  out.append(record(f'F cumsum {b} int32', t(
      lambda: torch.cumsum(vals, 0, dtype=torch.int32)), elems=b))
  # G: the TPU suite's Pallas row gather, by bulk copies on the card
  got = ops.row_gather_probe(feat, ridx)
  ref = ops.row_gather_probe_plain(feat, ridx)
  if not torch.equal(got, ref):
    raise RuntimeError('G: row_gather_probe != its plain version')
  out.append(record(f'G row_gather_probe kernel {rows} from [{n},128]',
                    t(lambda: ops.row_gather_probe(feat, ridx)), elems=rows,
                    nbytes=gbytes, max_abs_err=float((got - ref).abs().max()),
                    unique_rows=uniq))
  out.append(record('G  beside it: gather_rows_hbm kernel, same ids',
                    t(lambda: ops.gather_rows_hbm(feat, ridx)), elems=rows,
                    nbytes=gbytes))
  out.append(record('G  beside it: index_select, same ids',
                    t(lambda: torch.index_select(feat, 0, ridx64)),
                    elems=rows, nbytes=gbytes))
  # I: copy bandwidth
  side = 4096 // int(np.sqrt(shrink))
  big = torch.as_tensor(rng.standard_normal((side, side)).astype(
      np.float32)).to(device)
  out.append(record(f'I elementwise x + 1 over [{side},{side}] f32',
                    t(lambda: big + 1.0), elems=side * side,
                    nbytes=2 * side * side * 4))
  return out


def main(argv=None):
  import argparse
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--iters', type=int, default=20)
  args = ap.parse_args(argv)
  device = require_card()
  recs = run(device, args.iters)
  print_table(recs, f'# prof_mem on {torch.cuda.get_device_name(0)}')
  print(json.dumps({'prof_mem': recs}), flush=True)


if __name__ == '__main__':
  main()
