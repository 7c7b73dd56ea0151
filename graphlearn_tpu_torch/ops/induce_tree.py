"""Tree-mode inducer: positional relabeling, no dedup.

Counterpart of ``graphlearn_tpu/ops/induce_tree.py``: every sampled slot
is its own node (GraphSAGE's computation tree), so a slot's local index
is its hop offset plus its position, and each hop writes one contiguous
block of the node buffer.
"""
from typing import NamedTuple

import torch

from .unique import FILL


class TreeInducerState(NamedTuple):
  nodes: torch.Tensor      # [cap] global ids, FILL at invalid slots
  num_nodes: torch.Tensor  # 0-d int32: count of valid slots


def init_node_tree(seeds, seed_mask, capacity: int):
  """Start a batch: seed slot i is local index i.

  Returns ``(state, seeds_or_FILL, seed_mask, inverse)``.
  """
  b = seeds.shape[0]
  masked = torch.where(seed_mask, seeds, FILL)
  nodes = torch.full((capacity,), FILL, dtype=seeds.dtype,
                     device=seeds.device)
  nodes[:b] = masked
  count = seed_mask.sum().to(torch.int32)
  inverse = torch.where(
      seed_mask, torch.arange(b, dtype=torch.int32, device=seeds.device), -1)
  return TreeInducerState(nodes, count), masked, seed_mask, inverse


def init_empty_tree(capacity: int, dtype=torch.int32, device=None):
  """A tree state with no nodes yet (typed batches: a node type first
  reached mid-hop)."""
  return TreeInducerState(
      torch.full((capacity,), FILL, dtype=dtype, device=device),
      torch.zeros((), dtype=torch.int32, device=device))


def induce_next_tree(state: TreeInducerState, src_idx, nbrs, nbr_mask,
                     offset: int):
  """Absorb one hop: the hop block occupies slots
  ``[offset, offset + F*K)`` (``offset`` is the static prefix sum of hop
  capacities). Returns ``(new_state, out)``. The hop block is written
  into ``state.nodes`` in place: the sampler owns that buffer, and a copy
  per hop would only add traffic."""
  f, k = nbrs.shape
  size = f * k
  flat = nbrs.reshape(-1)
  flat_mask = nbr_mask.reshape(-1)
  local = offset + torch.arange(size, dtype=torch.int32, device=nbrs.device)
  frontier = torch.where(flat_mask, flat, FILL)
  state.nodes[offset:offset + size] = frontier
  num_new = flat_mask.sum().to(torch.int32)
  out = dict(
      rows=torch.where(flat_mask,
                       src_idx.to(torch.int32).repeat_interleave(k), -1),
      cols=torch.where(flat_mask, local, -1),
      edge_mask=flat_mask,
      frontier=frontier,
      frontier_idx=local,
      frontier_mask=flat_mask,
      num_new=num_new)
  return TreeInducerState(state.nodes, state.num_nodes + num_new), out
