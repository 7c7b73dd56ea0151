"""The legacy searchsorted inducer (``dedup='sort_legacy'``).

Counterpart of ``graphlearn_tpu/ops/induce.py`` in plain torch, bit for
bit: the state is a node buffer (position == local index, seeds first)
and a sorted view of it; each hop dedups its candidates by a masked
unique, finds the ones already held by a binary search of the view, and
appends the rest in ascending-id order. Slots past the buffer's capacity
are dropped (``mode='drop'``), while ``num_nodes`` keeps counting them,
as in JAX: the legacy engines have no clean-truncation contract.
"""
from typing import NamedTuple

import torch

from .induce_merge import repeat_each
from .unique import FILL, masked_unique


class InducerState(NamedTuple):
  nodes: torch.Tensor        # [cap] global ids, FILL-padded
  num_nodes: torch.Tensor    # 0-d int32
  sorted_vals: torch.Tensor  # [cap] ascending, INT32-MAX-padded
  sorted_pos: torch.Tensor   # [cap] position of sorted_vals in nodes


def _sort_view(nodes):
  keys = torch.where(nodes == FILL, torch.iinfo(nodes.dtype).max, nodes)
  order = torch.argsort(keys, stable=True)
  return keys[order], order.to(torch.int32)


def set_drop(buf, index, values):
  """``buf.at[index].set(values, mode='drop')`` into a new tensor, for
  indices unique within ``[0, len(buf))``: the others go to a spare last
  slot (a static shape, so no host sync on the card)."""
  n = buf.shape[0]
  out = torch.cat([buf, buf.new_empty(1)])
  index = torch.where((index >= 0) & (index < n), index, n)
  out.scatter_(0, index.long(), values.to(buf.dtype))
  return out[:n]


def scatter_drop(size: int, fill, dtype, index, values):
  """``jnp.full((size,), fill).at[index].set(values, mode='drop')``."""
  return set_drop(torch.full((size,), fill, dtype=dtype,
                             device=values.device), index, values)


def init_node(seeds, seed_mask, capacity: int):
  """Start a batch: dedup the seeds into local indices ``0..n-1``
  (ascending). Returns ``(state, uniq [B], uniq_mask [B], inverse [B])``."""
  b = seeds.shape[0]
  uniq, count, inverse = masked_unique(seeds, seed_mask, size=b)
  nodes = torch.full((capacity,), FILL, dtype=seeds.dtype,
                     device=seeds.device)
  nodes[:b] = uniq
  state = InducerState(nodes, count, *_sort_view(nodes))
  return state, uniq, torch.arange(b, device=seeds.device) < count, inverse


def init_empty(capacity: int, dtype=torch.int32, device=None):
  """A state with no nodes yet (the hetero engines' types first reached
  mid-hop)."""
  nodes = torch.full((capacity,), FILL, dtype=dtype, device=device)
  return InducerState(nodes, torch.zeros((), dtype=torch.int32,
                                         device=device), *_sort_view(nodes))


def induce_next(state: InducerState, src_idx, nbrs, nbr_mask):
  """Absorb one hop (``graphlearn_tpu/ops/induce.py:induce_next``).

  Returns ``(new_state, out)`` with ``out`` holding rows, cols (edge
  order of ``nbrs.reshape(-1)``), edge_mask, the compact frontier
  (frontier, frontier_idx, frontier_mask, ``[F*K]`` wide) and num_new."""
  f, k = nbrs.shape
  dev = nbrs.device
  size = f * k
  cap = state.nodes.shape[0]
  flat = nbrs.reshape(-1).to(state.nodes.dtype)
  flat_mask = nbr_mask.reshape(-1)
  ar = torch.arange(size, device=dev)

  uniq, ucnt, inv = masked_unique(flat, flat_mask, size=size)
  uniq_valid = ar < ucnt
  pos = torch.searchsorted(state.sorted_vals, uniq).clamp(0, cap - 1)
  found = (state.sorted_vals[pos] == uniq) & uniq_valid
  existing_idx = state.sorted_pos[pos]

  new_mask = uniq_valid & ~found
  new_rank = (torch.cumsum(new_mask, 0) - 1).to(torch.int32)
  new_idx = state.num_nodes + new_rank
  num_new = new_mask.sum().to(torch.int32)
  uniq_local = torch.where(uniq_valid,
                           torch.where(found, existing_idx, new_idx), -1)

  nodes = set_drop(state.nodes, torch.where(new_mask, new_idx, cap), uniq)
  new_state = InducerState(nodes, state.num_nodes + num_new,
                           *_sort_view(nodes))

  rows = torch.where(flat_mask, repeat_each(src_idx, k), -1)
  cols = torch.where(flat_mask, uniq_local[inv.clamp(0, size - 1).long()],
                     -1)
  slot = torch.where(new_mask, new_rank, size)
  out = dict(rows=rows, cols=cols, edge_mask=flat_mask,
             frontier=scatter_drop(size, FILL, flat.dtype, slot, uniq),
             frontier_idx=scatter_drop(size, -1, torch.int32, slot, new_idx),
             frontier_mask=ar < num_new, num_new=num_new)
  return new_state, out
