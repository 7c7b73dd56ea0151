"""Fixed-capacity routing for the cross-shard exchange.

Counterpart of ``graphlearn_tpu/ops/route.py``. Each shard packs its
outgoing ids into a dense ``[num_parts, capacity]`` bucket buffer
(FILL-padded), the exchange transposes shard and bucket, and responses
are un-permuted with the remembered ``(dest, slot)`` coordinates.

A bucket overflows only when more than ``capacity`` elements target one
destination, so a capacity of the request width is loss-free on every
input (every id on one part included). ``route_slots`` can also return
the overflow count, as a device tensor, for callers that trade capacity
for exchange volume.
"""
import math

import torch

from .unique import FILL


def round8(n: int) -> int:
  """Round up to a multiple of 8 (at least 8)."""
  return max(8, ((n + 7) // 8) * 8)


def exchange_capacity(request_width: int, nparts: int,
                      bucket_frac, hit_rate: float = 0.0) -> int:
  """The per-destination bucket capacity of one exchange:
  ``round8(bucket_frac * load / nparts)`` clamped to the loss-free full
  width, where ``load`` is ``request_width`` discounted by ``hit_rate``
  (the feature store's cache-hit floor; the sampler's exchange uses 0).
  ``bucket_frac=None`` or one part: the full width."""
  if bucket_frac is None or nparts <= 1:
    return request_width
  load = request_width
  if hit_rate > 0:
    load = max(0, math.ceil(request_width * (1.0 - float(hit_rate))))
  return min(request_width, round8(int(bucket_frac * load / nparts)))


def route_slots(dest, mask, capacity: int, with_overflow: bool = False):
  """Each element's slot within its destination bucket.

  Args:
    dest: ``[B]`` destination part per element.
    mask: ``[B]`` validity.
    capacity: the bucket capacity; ``capacity >= B`` never overflows.
    with_overflow: also return the number of valid elements beyond
      ``capacity`` in their bucket (a 0-d int32 tensor, not read back).

  Returns ``(slot [B] int32, ok [B])`` (``ok``: valid and within
  capacity), plus the overflow count under ``with_overflow``. The slot
  is the element's rank among the valid elements of its bucket, in
  input order: a stable sort by destination (masked elements last), and
  the rank within a group from a running max of the group starts.
  """
  b = dest.shape[0]
  dev = dest.device
  key = torch.where(mask, dest.to(torch.int32), 2 ** 30)
  order = torch.argsort(key, stable=True)
  sorted_key = key[order]
  idx = torch.arange(b, dtype=torch.int32, device=dev)
  is_first = torch.ones((b,), dtype=torch.bool, device=dev)
  is_first[1:] = sorted_key[1:] != sorted_key[:-1]
  group_start = torch.cummax(torch.where(is_first, idx, 0), 0).values
  slot = torch.empty((b,), dtype=torch.int32, device=dev)
  slot[order] = idx - group_start
  ok = mask & (slot < capacity)
  if with_overflow:
    return slot, ok, (mask & ~ok).sum().to(torch.int32)
  return slot, ok


def scatter_to_buckets(vals, dest, slot, ok, num_parts: int, capacity: int,
                       fill=FILL):
  """Pack ``[B]`` (or ``[B, ...]``) values into ``[num_parts, capacity,
  ...]``. Elements that are not ``ok`` (or lie past ``capacity``) go to a
  spare row that is cut off, so no boolean indexing and no host sync."""
  shape = (num_parts + 1, capacity) + tuple(vals.shape[1:])
  out = torch.full(shape, fill, dtype=vals.dtype, device=vals.device)
  keep = ok & (slot < capacity)
  d = torch.where(keep, dest.to(torch.int64), num_parts)
  s = torch.where(keep, slot.to(torch.int64), 0)
  out[d, s] = vals
  return out[:num_parts]


def gather_from_buckets(recv, dest, slot, ok, fill=FILL):
  """The inverse of the scatter: each element's response from
  ``recv[dest, slot]``, ``fill`` where not ``ok``."""
  safe_d = torch.where(ok, dest.to(torch.int64), 0)
  safe_s = torch.where(ok, slot.to(torch.int64), 0)
  out = recv[safe_d, safe_s]
  okb = ok.reshape((-1,) + (1,) * (out.dim() - 1))
  return torch.where(okb, out, fill)
