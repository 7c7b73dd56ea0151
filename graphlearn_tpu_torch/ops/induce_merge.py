"""Merge-sort exact inducer: cross-hop dedup and relabel built on sorts.

Counterpart of ``graphlearn_tpu/ops/induce_merge.py`` in plain torch, bit
for bit: every node sampled within a batch gets one local index (its
position in the node buffer), new nodes of a hop are numbered in
ascending-id order from the running count, and the state carries a
sorted view (``sorted_ids``/``sorted_loc``) of the node set that each hop
merges its candidates against. This is the CPU route of every merge
level (``ops.sample_level_fused``); on the card the level kernel
computes the same relabel map without the sorted view, which it leaves
stale.

The JAX two-key ``lax.sort`` becomes one sort of an int64 composite key
``(id << 32) | (payload + 2**31)``; the three other compaction sorts
become scatters to their (unique) sort keys, which give the same arrays.
"""
from typing import NamedTuple

import torch

from .unique import FILL, masked_unique

# payload encoding: state entries carry their local index (< _MARK);
# candidates carry _MARK + flat position. Static capacities above 4M
# nodes/edges per batch would alias — asserted per call.
_MARK = 1 << 22
_I32_MAX = torch.iinfo(torch.int32).max


class MergeInducerState(NamedTuple):
  nodes: torch.Tensor       # [cap] global ids, FILL-padded; pos == local idx
  num_nodes: torch.Tensor   # 0-d int32
  sorted_ids: torch.Tensor  # [cap] ascending ids, INT32-MAX-padded
  sorted_loc: torch.Tensor  # [cap] local index of sorted_ids (-1 padded)


def _seg_fill(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
  """Broadcast ``vals`` at flagged positions forward until the next flag,
  by the JAX package's three packed cummaxes (group rank in the high
  bits, one payload byte each in the low 8), so the values at unflagged
  positions before the first flag match it too."""
  n = vals.shape[0]
  assert n < (1 << 23), 'seg_fill capacity exceeds packed-cummax bound'
  grp = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
  v = torch.where(flags, vals, 0)
  out = torch.zeros_like(v)
  for shift in (0, 8, 16):
    packed = (grp << 8) | ((v >> shift) & 0xFF)
    out |= (torch.cummax(packed, 0).values & 0xFF) << shift
  return out


def init_node_merge(seeds: torch.Tensor, seed_mask: torch.Tensor,
                    capacity: int):
  """Start a batch: dedup seeds into local indices (ascending order).
  Returns ``(state, uniq [B], uniq_mask [B], inverse [B])``."""
  b = seeds.shape[0]
  dev = seeds.device
  uniq, count, inverse = masked_unique(seeds, seed_mask, size=b)
  big = torch.iinfo(seeds.dtype).max
  nodes = torch.full((capacity,), FILL, dtype=seeds.dtype, device=dev)
  nodes[:b] = uniq
  sorted_ids = torch.full((capacity,), big, dtype=seeds.dtype, device=dev)
  sorted_ids[:b] = torch.where(uniq == FILL, big, uniq)
  sorted_loc = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
  sorted_loc[:b] = torch.where(
      uniq == FILL, -1, torch.arange(b, dtype=torch.int32, device=dev))
  state = MergeInducerState(nodes, count, sorted_ids, sorted_loc)
  return state, uniq, torch.arange(b, device=dev) < count, inverse


def init_empty_merge(capacity: int, dtype=torch.int32, device=None):
  """A merge-inducer state with no nodes yet (the hetero engines' lazy
  per-type states)."""
  big = torch.iinfo(dtype).max
  return MergeInducerState(
      torch.full((capacity,), FILL, dtype=dtype, device=device),
      torch.zeros((), dtype=torch.int32, device=device),
      torch.full((capacity,), big, dtype=dtype, device=device),
      torch.full((capacity,), -1, dtype=torch.int32, device=device))


def repeat_each(src_idx, k: int):
  """``repeat(src_idx, k)`` as int32, by a broadcast (a static shape: no
  host sync on the card)."""
  return src_idx.to(torch.int32)[:, None].expand(-1, k).reshape(-1)


def append_block(nodes: torch.Tensor, block: torch.Tensor, start):
  """``lax.dynamic_update_slice(nodes, block, (start,))`` in place: the
  start (a 0-d device tensor, never read on the host) is clamped to
  ``[0, cap - len(block)]`` as XLA clamps it. Under the clamped-growth
  invariant (``num_nodes <= prefix_cap`` before every hop, and
  ``len(block) <= cap - prefix_cap``) the clamp never moves the start."""
  limit = block.shape[0]
  assert limit <= nodes.shape[0], (limit, nodes.shape[0])
  at = torch.clamp(start, 0, nodes.shape[0] - limit).to(torch.int64)
  nodes.index_copy_(0, at + torch.arange(limit, device=nodes.device),
                    block)
  return nodes


def merge_frontier(block, size: int, num_nodes, num_kept):
  """``(frontier, frontier_idx, frontier_mask)`` of a hop whose append
  block is ``block``: the block FILL-padded to the hop's ``size``
  candidates, the new nodes' local indices, and their validity."""
  dev = block.device
  limit = block.shape[0]
  frontier = block if limit == size else torch.cat(
      [block, torch.full((size - limit,), FILL, dtype=block.dtype,
                         device=dev)])
  ar = torch.arange(size, dtype=torch.int32, device=dev)
  fin = ar < num_kept
  frontier_idx = torch.where(fin, num_nodes + ar, -1)
  return frontier, frontier_idx, fin


def induce_next_merge(state: MergeInducerState, src_idx, nbrs, nbr_mask,
                      prefix_cap: int, max_new=None,
                      update_view: bool = True):
  """Absorb one hop: edge arrays in ``nbrs.reshape(-1)`` order, the new
  nodes appended as one block that is also the (compact) next frontier.

  Args:
    prefix_cap: static max node count before this hop (the clamped
      occupancy bound of ``merge_layout_from_caps``); bounds the sorted
      prefix this hop merges against and keeps the append in bounds.
    max_new: static clamp on nodes kept this hop (the plan's
      ``caps[i+1]``); None = the hop's full candidate width.
    update_view: rebuild the sorted view (skipped on the final hop).

  ``state.nodes`` is updated in place (the sampler owns the buffer).
  Returns ``(new_state, out)`` with ``out`` holding rows, cols,
  edge_mask, frontier, frontier_idx, frontier_mask and the RAW new
  unique count ``num_new`` (overflow shows as ``num_new > max_new``).
  """
  f, k = nbrs.shape
  size = f * k
  cap = state.nodes.shape[0]
  c = min(prefix_cap, cap)
  dev = nbrs.device
  # encoding bounds of the JAX engine: state payloads (local idx < cap)
  # stay below _MARK, candidate payloads (_MARK + pos) fit int32, and
  # _seg_fill's 3-byte payload holds every local index (< cap + size)
  assert cap <= _MARK and _MARK + size < 2 ** 31, \
      'batch capacity exceeds payload encoding'
  assert cap + size < (1 << 24), \
      'cap + hop size exceeds the seg_fill 3-byte payload bound'
  big = _I32_MAX
  num_nodes = state.num_nodes

  flat = nbrs.reshape(-1).to(state.nodes.dtype)
  flat_mask = nbr_mask.reshape(-1)

  # -- sort #1: merged (state prefix ++ candidates), keys then payload --
  keys = torch.cat([state.sorted_ids[:c], torch.where(flat_mask, flat, big)])
  payload = torch.cat([
      state.sorted_loc[:c],
      _MARK + torch.arange(size, dtype=torch.int32, device=dev)])
  comp = (keys.to(torch.int64) << 32) | (payload.to(torch.int64) + 2 ** 31)
  comp = torch.sort(comp).values
  keys_s = (comp >> 32).to(torch.int32)
  pay_s = ((comp & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)

  valid = keys_s != big
  is_state = pay_s < _MARK
  first = valid.clone()
  first[1:] &= keys_s[1:] != keys_s[:-1]
  winner = first & ~is_state           # first occurrence, no state entry
  rank = (torch.cumsum(winner, 0) - 1).to(torch.int32)
  num_new = winner.sum().to(torch.int32)
  limit = min(size, cap - c, size if max_new is None else max_new)
  num_kept = torch.clamp(num_new, max=limit)
  base = torch.where(is_state, pay_s, num_nodes + rank)
  local_all = _seg_fill(torch.where(first, base, -1), first)

  # -- sort #2: candidate locals back to flat order (a scatter to the
  # unique flat positions) ------------------------------------------------
  # (each candidate position appears once; state entries go to a spare
  # last slot, so the scatter needs no boolean index and no host sync)
  cand = valid & ~is_state
  at = torch.where(is_state, size, pay_s - _MARK).long()
  cols = torch.empty((size + 1,), dtype=torch.int32, device=dev)
  cols.scatter_(0, at, torch.where(cand, local_all, -1))
  cols = cols[:size]
  # edges to overflow-truncated winners (local idx past the stored
  # region) are masked out; a no-op on unclamped plans
  emask = flat_mask & (cols >= 0) & (cols < num_nodes + num_kept)
  cols = torch.where(emask, cols, -1)
  rows = torch.where(emask, repeat_each(src_idx, k), -1)

  # -- sort #3: winners -> the append block (a scatter to their ranks) --
  kept = winner & (rank < limit)
  block = torch.full((limit + 1,), FILL, dtype=state.nodes.dtype, device=dev)
  block.scatter_(0, torch.where(kept, rank, limit).long(),
                 torch.where(kept, keys_s, FILL))
  block = block[:limit]
  nodes = append_block(state.nodes, block, num_nodes)
  frontier, frontier_idx, fin = merge_frontier(block, size, num_nodes,
                                               num_kept)

  # -- sort #4: the new sorted view prefix [c + size] --------------------
  if update_view:
    # truncated winners (rank >= limit) were never stored: not in the view
    keep = valid & (is_state | (winner & (rank < limit)))
    sid = torch.where(keep, keys_s, big)
    sloc = torch.where(keep, local_all, -1)
    order = torch.argsort(sid, stable=True)
    sid, sloc = sid[order], sloc[order]
    if c + size < cap:
      sorted_ids = torch.cat([sid, state.sorted_ids[c + size:]])
      sorted_loc = torch.cat([sloc, state.sorted_loc[c + size:]])
    else:
      sorted_ids, sorted_loc = sid[:cap], sloc[:cap]
  else:
    sorted_ids, sorted_loc = state.sorted_ids, state.sorted_loc

  out = dict(rows=rows, cols=cols, edge_mask=emask, frontier=frontier,
             frontier_idx=frontier_idx, frontier_mask=fin, num_new=num_new)
  return MergeInducerState(nodes, num_nodes + num_kept, sorted_ids,
                           sorted_loc), out
