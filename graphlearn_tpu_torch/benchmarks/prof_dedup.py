"""Probe suite behind the exact-dedup design: element gathers and
scatters against table size, sorts, and a take from a table held on chip.

The port of ``benchmarks/prof_dedup.py``: the same operations at the
same sizes (S = 786,432 ids; tables of 2^13 to 2^24 entries), in torch
on the card, each timed by CUDA events after warm-up
(``benchmarks.common.device_ms``) and printed as device ms and M elem/s.
On the TPU this suite found random element gathers and scatters at
~140-200 M/s whatever the table size, and a 768k key+payload sort 3-5x
cheaper than one random gather of the same size, the rule the sort-based
merge engine and gather v2 were built on; this suite asks the card the
same questions.

The TPU suite's Pallas probe (a ``jnp.take`` from a 65,536-entry int32
table held in VMEM, which never lowered there) is the ``smem_take``
kernel (``csrc/smem_take.cu``: a cluster of ``ops.probes.
SMEM_TAKE_CLUSTER`` CTAs holds the 256 KB table in shared memory, one
part each), held against its plain version before it is timed and set
beside ``torch.take``.

Differences from the TPU suite: eager torch has no dead-code
elimination, so no probe sums its result; scatters write into their
table in place; ``torch.sort`` always returns the sorting indices, so a
sort carries the source-slot payload of ``sort_pair_*`` (whose payload
is ``arange(S)``) at no extra call.

Run on the card: python -m graphlearn_tpu_torch.benchmarks.prof_dedup
"""
import json

import numpy as np
import torch

from .. import ops
from .common import device_ms, print_table, record, require_card

S = 768 * 1024      # candidate stream (hop-3 scale of a products batch)
TN = 1 << 16        # the on-chip table of the take probe: 256 KB


def run(device, iters: int = 8, shrink: int = 1):
  """Every probe on ``device``; S divided by ``shrink`` (a rehearsal on
  the CPU). Returns the probe records."""
  s = S // shrink // 512 * 512
  rng = np.random.default_rng(0)
  out = []
  t = lambda fn: device_ms(fn, device, iters)   # noqa: E731
  dev = lambda a: torch.as_tensor(a).to(device)   # noqa: E731

  for logn in (13, 16, 20, 24):
    n = 1 << logn
    table = dev(rng.integers(0, 1 << 30, n, dtype=np.int32))
    idx = dev(rng.integers(0, n, s, dtype=np.int32)).long()
    out.append(record(f'gather_n{logn}', t(lambda: table[idx]), elems=s))
  for logn in (16, 20, 24):
    n = 1 << logn
    table = torch.zeros(n, dtype=torch.int32, device=device)
    idx = dev(rng.integers(0, n, s, dtype=np.int32)).long()
    vals = dev(rng.integers(0, 1 << 30, s, dtype=np.int32))
    out.append(record(f'scatter_n{logn}',
                      t(lambda: table.index_put_((idx,), vals)), elems=s))
  del table
  ids = dev(rng.integers(0, 1 << 20, s, dtype=np.int32))
  lanes, lanes512 = ids.view(-1, 128), ids.view(-1, 512)
  out.append(record('sort_1d', t(lambda: torch.sort(ids)), elems=s))
  out.append(record('sort_lanes', t(lambda: torch.sort(lanes, dim=0)),
                    elems=s))
  out.append(record('sort_lanes512', t(lambda: torch.sort(lanes512, dim=0)),
                    elems=s))
  out.append(record('argsort_1d', t(lambda: torch.argsort(ids, stable=True)),
                    elems=s))
  out.append(record('sort_pair_1d', t(lambda: torch.sort(ids, stable=True)),
                    elems=s))
  out.append(record('sort_pair_lanes',
                    t(lambda: torch.sort(lanes, dim=0, stable=True)),
                    elems=s))
  tbl2 = dev(rng.integers(0, 1 << 30, (8192, 128), dtype=np.int32))
  li = dev(rng.integers(0, 8192, (s // 128, 128), dtype=np.int32)).long()
  out.append(record('take_along_lanes',
                    t(lambda: torch.take_along_dim(tbl2, li, dim=0)),
                    elems=s))
  # the TPU suite's Pallas take, from a table held in shared memory
  ptable = dev(rng.integers(0, 1 << 30, TN, dtype=np.int32))
  pidx = dev(rng.integers(0, TN, (s // 128, 128), dtype=np.int32))
  got = ops.smem_take(ptable, pidx)
  ref = ops.smem_take_plain(ptable, pidx)
  if not torch.equal(got, ref):
    raise RuntimeError('smem_take != its plain version')
  pidx64 = pidx.long()
  out.append(record('smem_take kernel (pallas_vmem_take)',
                    t(lambda: ops.smem_take(ptable, pidx)), elems=s,
                    nbytes=2 * s * 4 + TN * 4,
                    max_abs_err=float((got - ref).abs().max())))
  out.append(record('  beside it: torch.take, same ids',
                    t(lambda: torch.take(ptable, pidx64)), elems=s))
  return out


def main(argv=None):
  import argparse
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--iters', type=int, default=8)
  args = ap.parse_args(argv)
  device = require_card()
  recs = run(device, args.iters)
  print_table(recs, f'# prof_dedup on {torch.cuda.get_device_name(0)}')
  print(json.dumps({'prof_dedup': recs}), flush=True)


if __name__ == '__main__':
  main()
