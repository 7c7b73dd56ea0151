"""The legacy direct-address inducer (``dedup='map_table'``).

Counterpart of ``graphlearn_tpu/ops/induce_map.py`` in plain torch, bit
for bit: a dense ``[N]`` table maps a global id to its local index + 1
(0: absent), and every step is a gather, a scatter or a cumsum over the
hop block, with no sort. Among the duplicates of a new id the LAST
position wins the table slot, which is what XLA's CPU scatter keeps
(``scatter_reduce('amax')`` of the positions, deterministic on every
device); the winner fixes the new nodes' order. Slots past the node
buffer's capacity are dropped while ``num_nodes`` keeps counting them,
as in JAX.
"""
from typing import NamedTuple

import torch

from .induce import scatter_drop, set_drop
from .induce_merge import repeat_each
from .unique import FILL


class MapInducerState(NamedTuple):
  table: torch.Tensor      # [N] global id -> local index + 1 (0 = absent)
  nodes: torch.Tensor      # [cap] global ids, FILL-padded; pos == local idx
  num_nodes: torch.Tensor  # 0-d int32


def _winners(n_table: int, ids, cand, none: int):
  """``cand`` positions that win their id's probe slot: the last
  candidate position of each id (``probe.at[ids].set(pos)`` on XLA's
  CPU backend)."""
  size = ids.shape[0]
  pos = torch.arange(size, dtype=torch.int32, device=ids.device)
  probe = torch.full((n_table + 1,), none, dtype=torch.int32,
                     device=ids.device)
  probe.scatter_reduce_(0, torch.where(cand, ids, n_table).long(), pos,
                        'amax', include_self=False)
  return cand & (probe[ids.long()] == pos)


def init_node_map(seeds, seed_mask, capacity: int, num_graph_nodes: int):
  """Start a batch: dedup the seeds into local indices in first-winner
  order. Returns ``(state, uniq [B], uniq_mask [B], inverse [B])``."""
  b = seeds.shape[0]
  dev = seeds.device
  safe = torch.where(seed_mask, seeds, 0)
  winner = _winners(num_graph_nodes, safe, seed_mask, b)
  rank = (torch.cumsum(winner, 0) - 1).to(torch.int32)
  count = winner.sum().to(torch.int32)
  nodes = scatter_drop(capacity, FILL, seeds.dtype,
                       torch.where(winner, rank, capacity), seeds)
  table = scatter_drop(num_graph_nodes, 0, torch.int32,
                       torch.where(winner, safe, num_graph_nodes), rank + 1)
  inverse = torch.where(seed_mask, table[safe.long()] - 1, -1)
  return (MapInducerState(table, nodes, count), nodes[:b],
          torch.arange(b, device=dev) < count, inverse)


def induce_next_map(state: MapInducerState, src_idx, nbrs, nbr_mask,
                    compact_frontier: bool = True):
  """Absorb one hop (``graphlearn_tpu/ops/induce_map.py:induce_next_map``;
  the output contract of ``ops.induce.induce_next``).
  ``compact_frontier=False`` emits the frontier positionally (mask =
  winner), valid only when its consumer keeps the full width."""
  f, k = nbrs.shape
  size = f * k
  dev = nbrs.device
  n_table = state.table.shape[0]
  cap = state.nodes.shape[0]
  flat = nbrs.reshape(-1).to(state.nodes.dtype)
  flat_mask = nbr_mask.reshape(-1)
  safe = torch.where(flat_mask, flat, 0)

  existing = state.table[safe.long()]
  winner = _winners(n_table, safe, flat_mask & (existing == 0), size)
  rank = (torch.cumsum(winner, 0) - 1).to(torch.int32)
  num_new = winner.sum().to(torch.int32)
  new_idx = state.num_nodes + rank

  nodes = set_drop(state.nodes, torch.where(winner, new_idx, cap), flat)
  table = set_drop(state.table, torch.where(winner, safe, n_table),
                   new_idx + 1)
  local = torch.where(flat_mask, table[safe.long()] - 1, -1)
  rows = torch.where(flat_mask, repeat_each(src_idx, k), -1)
  if compact_frontier:
    slot = torch.where(winner, rank, size)
    frontier = scatter_drop(size, FILL, flat.dtype, slot, flat)
    frontier_idx = scatter_drop(size, -1, torch.int32, slot, new_idx)
    frontier_mask = torch.arange(size, device=dev) < num_new
  else:
    frontier = torch.where(winner, flat, FILL)
    frontier_idx = torch.where(winner, new_idx, -1)
    frontier_mask = winner
  out = dict(rows=rows, cols=local, edge_mask=flat_mask, frontier=frontier,
             frontier_idx=frontier_idx, frontier_mask=frontier_mask,
             num_new=num_new)
  return MapInducerState(table, nodes, state.num_nodes + num_new), out
