"""Padding sentinel and masked, fixed-shape unique.

Counterpart of ``graphlearn_tpu/ops/unique.py``: ``FILL``,
``masked_unique`` (sort-based, static output size), which the merge
inducer uses to dedup a batch's seeds, and ``searchsorted_membership``.
"""
import torch

FILL = -1  # invalid/padded ids (all real ids are >= 0)


def masked_unique(ids: torch.Tensor, mask: torch.Tensor, size: int):
  """Deduplicate ``ids[mask]`` into a fixed-size buffer.

  Returns:
    uniq:    ``[size]`` unique values in ascending order, FILL-padded.
    count:   0-d int32 number of valid uniques.
    inverse: ``[N]`` int32 index into ``uniq`` per input position (-1
      where masked).
  """
  n = ids.shape[0]
  assert size >= 1
  big = torch.iinfo(ids.dtype).max
  x = torch.where(mask, ids, big)
  order = torch.argsort(x, stable=True)
  xs = x[order]
  is_first = torch.ones_like(xs, dtype=torch.bool)
  is_first[1:] = xs[1:] != xs[:-1]
  is_new = is_first & (xs != big)
  uidx = (torch.cumsum(is_new, 0) - 1).to(torch.int32)
  count = is_new.sum().to(torch.int32)
  # jax's mode='drop': everything not kept goes to a spare slot past
  # ``size`` (a static shape, so no host sync on the card)
  uniq = torch.full((size + 1,), FILL, dtype=ids.dtype, device=ids.device)
  keep = is_new & (uidx < size)
  uniq.scatter_(0, torch.where(keep, uidx, size).long(), xs)
  uniq = uniq[:size]
  inverse = torch.empty((n,), dtype=torch.int32, device=ids.device)
  inverse[order] = uidx
  inverse = torch.where(mask, inverse, -1)
  return uniq, count, inverse


def searchsorted_membership(sorted_vals: torch.Tensor, queries: torch.Tensor):
  """Membership of ``queries`` in ascending ``sorted_vals`` (which may end
  in int-max padding): ``(found, pos)``, ``pos`` clamped into
  ``sorted_vals`` (the left insertion point, as ``jnp.searchsorted``)."""
  pos = torch.searchsorted(sorted_vals, queries)
  pos = torch.clamp(pos, 0, sorted_vals.shape[0] - 1)
  return sorted_vals[pos] == queries, pos
