"""Timing for the probe suites: device milliseconds by CUDA events.

Each probe is called a few times to warm up, then ``iters`` times in a
row queued behind a spin kernel (``torch.cuda._sleep``), between two CUDA
events: the host enqueues the calls while the card spins, so the time
between the events is the card's time for the calls and not the host's
launch cost. On the CPU (a rehearsal at small sizes, which a caller asks
for by passing the CPU device) the host clock stands in.
"""
import time

import torch

SPIN_CYCLES = 4_000_000   # ~2 ms of spin ahead of the timed calls
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA's H100 SXM data sheet


def require_card() -> torch.device:
  """The card; a probe suite run as a program measures nothing else."""
  if not torch.cuda.is_available():
    raise SystemExit('the probe suites time the card: no CUDA device is '
                     'available')
  return torch.device('cuda')


def device_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
  """Milliseconds per call of ``fn`` on ``device``."""
  for _ in range(warmup):
    fn()
  if device.type != 'cuda':
    t0 = time.perf_counter()
    for _ in range(iters):
      fn()
    return (time.perf_counter() - t0) * 1e3 / iters
  torch.cuda.synchronize()
  a = torch.cuda.Event(enable_timing=True)
  b = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(SPIN_CYCLES)
  a.record()
  for _ in range(iters):
    fn()
  b.record()
  b.synchronize()
  return a.elapsed_time(b) / iters


def record(name: str, ms: float, elems=None, nbytes=None, **extra) -> dict:
  """A probe's line: ms, and M elem/s and GB/s where they apply."""
  rec = dict(probe=name, ms=ms)
  if elems is not None:
    rec.update(elems=elems, m_elem_per_s=elems / ms / 1e3)
  if nbytes is not None:
    rec.update(bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
  rec.update(extra)
  return rec


def print_table(records, header: str):
  print(header, flush=True)
  for r in records:
    rate = ''
    if 'm_elem_per_s' in r:
      rate += f'  {r["m_elem_per_s"]:10.1f} M elem/s'
    if 'gb_per_s' in r:
      rate += f'  {r["gb_per_s"]:8.1f} GB/s'
    print(f'{r["probe"]:48s} {r["ms"]:9.4f} ms{rate}', flush=True)
