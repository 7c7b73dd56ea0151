"""Fixed-shape uniform neighbor sampling over a device CSR.

Counterpart of ``graphlearn_tpu/ops/neighbor.py:uniform_sample`` in plain
torch: a dense ``[B, K]`` draw with a validity mask (deg <= K keeps all
neighbors in order; deg > K draws K with replacement). It is the plain
version of the fused hop (``ops.sample_hop_fused``), whose kernel runs
the same draw (``_draw``) and the gather in one launch.
"""
import torch

from .. import random as trandom
from .unique import FILL


def _seed_rows(indptr, meta, seeds, seed_mask):
  """(start, deg) ``[B]`` int32 of each seed's CSR row; masked seeds read
  row 0. ``meta`` is the packed ``[N, 2]`` row table, or None for two
  ``indptr`` reads."""
  safe = torch.where(seed_mask, seeds, 0).long()
  if meta is not None:
    row = meta[safe]
    return row[:, 0].contiguous(), row[:, 1].contiguous()
  start = indptr[safe]
  return start, indptr[safe + 1] - start


def _draw(start, deg, seed_mask, k: int, key):
  """The uniform offset draw (``graphlearn_tpu/ops/sample_fused.py:_draw``).
  The offset is ``floor(u * float32(deg))`` in float32, clamped to ``deg -
  1``; deg <= k keeps the first deg slots in order."""
  b = seed_mask.shape[0]
  u = trandom.uniform(key, (b, k), device=start.device)
  d = deg[:, None]
  rand_off = torch.floor(u * d.to(torch.float32)).to(torch.int32)
  rand_off = torch.minimum(rand_off, torch.clamp(d - 1, min=0))
  seq_off = torch.arange(k, dtype=torch.int32, device=start.device)[None, :]
  offsets = torch.where(d > k, rand_off, seq_off)
  mask = seed_mask[:, None] & (offsets < d)
  epos = start[:, None] + offsets
  return epos, mask


def pick(indices, safe_epos):
  """``indices[safe_epos]``, or zeros for an empty graph (where the draw
  masks every slot)."""
  if indices.shape[0] == 0:
    return torch.zeros_like(safe_epos, dtype=torch.int32)
  return indices[safe_epos.long()]


def uniform_sample(indptr, indices, seeds, seed_mask, k: int, key,
                   meta=None):
  """Sample up to ``k`` neighbors per seed.

  Returns ``(nbrs [B, K] FILL-padded, epos [B, K] 0-padded, mask)``.
  """
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)
  return torch.where(mask, pick(indices, safe_epos), FILL), safe_epos, mask
