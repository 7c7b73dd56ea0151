"""Fused sample+gather CSR hop, and the fused sample+dedup merge level.

Counterpart of ``graphlearn_tpu/ops/sample_fused.py`` (``_draw``,
``sample_hop_fused``, ``sample_level_fused``). The offset draw is plain
torch on the port's threefry stream, byte for byte the JAX package's;
the rest is the kernels' job:

- ``sample_hop``: ``indices[safe_epos]`` for one hop. On a CUDA tensor it
  launches ``csrc/sample_hop.cu`` (one thread per pick); on a CPU tensor
  it runs the plain ``indices[safe_epos]``.
- ``sample_level``: the picks of one merge level and their exact-dedup
  relabel map against the node buffer (``cols_raw``, the append block,
  the raw new count). On a CUDA tensor it launches
  ``csrc/sample_level.cu``; on a CPU tensor it runs
  ``sample_level_plain``.

The JAX kernels read a ``[ceil(E/128), 128]`` lane-aligned view of the
indices (``build_indices128``), a TPU layout. The port reads the flat
``[E]`` indices, so ``blocks128`` must be None here, and it takes no
``window``: the JAX kernels' segment staging has no counterpart (see
``csrc/sample_hop.cu``).
"""
import torch

from .. import random as trandom
from . import kernels
from .induce_merge import (MergeInducerState, append_block,
                           induce_next_merge, merge_frontier, repeat_each)
from .unique import FILL

# launches of the CUDA kernels (plain-version calls do not count):
# ``launches`` counts sample_hop, ``level_launches`` sample_level
launches = 0
level_launches = 0


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
  """The uniform offset draw of ``ops.uniform_sample``. The offset is
  ``floor(u * float32(deg))`` in float32, clamped to ``deg - 1``; deg <=
  k keeps the first deg slots in order."""
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


def sample_hop_plain(indices, safe_epos):
  """``indices[safe_epos]`` in plain torch (any device)."""
  return indices[safe_epos.long()]


def sample_hop(indices, safe_epos):
  """``indices[safe_epos]`` for one hop.

  Args:
    indices: ``[E]`` int32 CSR indices (E > 0).
    safe_epos: ``[B, k]`` int32 edge positions in ``[0, E)``.

  Returns ``[B, k]`` int32 (raw: masked slots read ``indices[epos]``).
  """
  if indices.device.type == 'cpu' and safe_epos.device.type == 'cpu':
    return sample_hop_plain(indices, safe_epos)
  _check(indices, safe_epos)
  global launches
  out = torch.empty(safe_epos.shape, dtype=torch.int32,
                    device=indices.device)
  if out.numel() == 0:
    return out
  err = kernels.lib('sample_hop').glt_sample_hop(
      indices.data_ptr(), indices.shape[0], safe_epos.data_ptr(),
      out.data_ptr(), out.numel(), indices.device.index or 0,
      torch.cuda.current_stream(indices.device).cuda_stream)
  kernels.check(err, 'sample_hop')
  launches += 1
  return out


def _check(indices, safe_epos):
  dev = indices.device
  if dev.type != 'cuda' or safe_epos.device != dev:
    raise ValueError('sample_hop: indices and epos must lie on one CUDA '
                     'device')
  for name, t, nd in (('indices', indices, 1), ('epos', safe_epos, 2)):
    if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
      raise ValueError(f'sample_hop: {name} must be a contiguous {nd}-D '
                       f'int32 tensor, got {tuple(t.shape)} {t.dtype}')
  if indices.shape[0] == 0:
    raise ValueError('sample_hop: empty indices')


def sample_hop_fused(indptr, indices, blocks128, seeds, seed_mask, k: int,
                     key, meta=None):
  """One uniform CSR hop; the output contract and PRNG stream of
  ``ops.uniform_sample``.

  Args:
    indptr / indices: the CSR (``indptr`` is read when ``meta`` is None).
    blocks128: must be None (the port reads the flat indices).
    seeds / seed_mask: ``[B]`` int32 / bool.
    k: fanout. key: threefry key (``random.PRNGKey`` family).
    meta: optional ``[N, 2]`` (start, degree) row table.

  Returns ``(nbrs [B, k] FILL-padded, epos [B, k] 0-padded, mask [B, k])``.
  """
  if blocks128 is not None:
    raise ValueError('the port reads the flat indices: pass blocks128=None')
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)
  if indices.shape[0] == 0:
    picked = torch.zeros_like(safe_epos)
  else:
    picked = sample_hop(indices, safe_epos)
  nbrs = torch.where(mask, picked, FILL)
  return nbrs, safe_epos, mask


def _pick(indices, safe_epos):
  """``indices[safe_epos]`` flat, or zeros for an empty graph (where the
  draw masks every slot)."""
  flat = safe_epos.reshape(-1)
  if indices.shape[0] == 0:
    return torch.zeros_like(flat, dtype=torch.int32)
  return indices[flat.long()]


def sample_level_plain(indices, safe_epos, mask, nodes_prefix, num_nodes,
                       limit: int, num_graph_nodes: int):
  """The level kernel's function in plain torch (any device).

  Args:
    indices: ``[E]`` int32 CSR indices.
    safe_epos / mask: ``[F, k]`` int32 edge positions in ``[0, E)`` and
      their validity.
    nodes_prefix: ``[c]`` int32 node-buffer prefix; its first
      ``num_nodes`` slots are occupied (position == local index).
    num_nodes: 0-d int32.
    limit: static number of new nodes the append block holds.
    num_graph_nodes: N; every id lies in ``[0, N)``.

  Returns ``(picked [S], cols_raw [S], block [limit], num_new)``, S =
  F·k: the raw picks; per candidate -1 where masked, else its prefix
  position if the prefix holds it, else ``num_nodes + rank`` with
  ``rank`` its id's place among the distinct new ids in ascending order;
  the first ``min(num_new, limit)`` new ids ascending, FILL past them;
  and the 0-d int32 count of distinct new ids. Ids outside ``[0, N)``
  (impossible from a CSR of N rows) get column -1, as in the kernel.
  """
  picked = _pick(indices, safe_epos)
  valid = mask.reshape(-1)
  dev = picked.device
  c = nodes_prefix.shape[0]
  pos = torch.arange(c, dtype=torch.int32, device=dev)
  occupied = (pos < num_nodes) & (nodes_prefix >= 0)
  order = torch.argsort(nodes_prefix[occupied], stable=True)
  sids, spos = nodes_prefix[occupied][order], pos[occupied][order]
  # last equal entry = the largest position, as the kernel's atomicMax
  at = torch.searchsorted(sids, picked, right=True) - 1
  found = valid & (at >= 0) & (sids[at.clamp(min=0)] == picked) \
      if sids.numel() else torch.zeros_like(valid)
  new = valid & ~found & (picked >= 0) & (picked < num_graph_nodes)
  uniq = torch.unique(picked[new])            # ascending
  rank = torch.searchsorted(uniq, picked).to(torch.int32)
  cols_raw = torch.where(
      found, spos[at.clamp(min=0)] if sids.numel() else -1,
      torch.where(new, num_nodes + rank, -1)).to(torch.int32)
  num_new = torch.tensor(uniq.numel(), dtype=torch.int32, device=dev)
  block = torch.full((limit,), FILL, dtype=torch.int32, device=dev)
  kept = min(uniq.numel(), limit)
  block[:kept] = uniq[:kept]
  return picked, cols_raw, block, num_new


def sample_level(indices, safe_epos, mask, nodes_prefix, num_nodes,
                 limit: int, num_graph_nodes: int):
  """One merge level's picks and relabel map (``sample_level_plain``'s
  arguments and outputs). On CUDA tensors it launches
  ``csrc/sample_level.cu`` and never synchronises: ``num_new`` stays on
  the device. On CPU tensors it runs ``sample_level_plain``."""
  args = (indices, safe_epos, mask, nodes_prefix, num_nodes)
  if all(t.device.type == 'cpu' for t in args):
    return sample_level_plain(*args, limit, num_graph_nodes)
  _check_level(*args, limit, num_graph_nodes)
  global level_launches
  dev = indices.device
  s = safe_epos.numel()
  c = nodes_prefix.shape[0]
  lib = kernels.lib('sample_level')
  scratch = torch.empty(lib.glt_sample_level_scratch(num_graph_nodes, c),
                        dtype=torch.int32, device=dev)
  picked = torch.empty(s, dtype=torch.int32, device=dev)
  cols_raw = torch.empty(s, dtype=torch.int32, device=dev)
  block = torch.empty(limit, dtype=torch.int32, device=dev)
  num_new = torch.empty((), dtype=torch.int32, device=dev)
  err = lib.glt_sample_level(
      indices.data_ptr(), indices.shape[0], safe_epos.data_ptr(),
      mask.data_ptr(), s, nodes_prefix.data_ptr(), c, num_nodes.data_ptr(),
      num_graph_nodes, limit, scratch.data_ptr(), picked.data_ptr(),
      cols_raw.data_ptr(), block.data_ptr(), num_new.data_ptr(),
      dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
  kernels.check(err, 'sample_level')
  level_launches += 1
  return picked, cols_raw, block, num_new


def _check_level(indices, safe_epos, mask, nodes_prefix, num_nodes, limit,
                 num_graph_nodes):
  dev = indices.device
  tensors = (('indices', indices, torch.int32, 1),
             ('epos', safe_epos, torch.int32, 2),
             ('mask', mask, torch.bool, 2),
             ('nodes_prefix', nodes_prefix, torch.int32, 1),
             ('num_nodes', num_nodes, torch.int32, 0))
  if dev.type != 'cuda' or any(t.device != dev for _, t, _, _ in tensors):
    raise ValueError('sample_level: every tensor must lie on one CUDA '
                     'device')
  for name, t, dtype, nd in tensors:
    if t.dtype != dtype or t.dim() != nd or not t.is_contiguous():
      raise ValueError(f'sample_level: {name} must be a contiguous {nd}-D '
                       f'{dtype} tensor, got {tuple(t.shape)} {t.dtype}')
  if mask.shape != safe_epos.shape:
    raise ValueError('sample_level: mask and epos shapes differ')
  if not 0 < num_graph_nodes < 2 ** 31:
    raise ValueError(f'sample_level: the id bitmap takes 0 < N < 2**31 '
                     f'nodes, got {num_graph_nodes}')
  if nodes_prefix.shape[0] > 2 ** 29 or limit < 0:
    raise ValueError(f'sample_level: prefix of {nodes_prefix.shape[0]} '
                     f'slots or limit {limit} out of range')


def sample_level_fused(indptr, indices, blocks128, seeds, seed_mask, k: int,
                       key, state: MergeInducerState, src_idx, meta=None, *,
                       prefix_cap: int, max_new=None, final: bool = False):
  """One whole fanout level of the merge engine (sample, gather, exact
  dedup), equal to ``ops.uniform_sample`` followed by
  ``ops.induce_next_merge``.

  The draw stays outside the kernel, on the JAX package's threefry
  stream. On CUDA tensors ``sample_level`` resolves the picks and the
  relabel map in the level kernel, and this function applies the JAX
  kernel path's epilogue (truncation mask, edge rows, node append,
  frontier); the sorted view is left stale, as on the TPU (no later
  level reads it there). On CPU tensors it takes the JAX fallback:
  ``indices[safe_epos]`` and ``induce_next_merge(update_view=not
  final)``, which maintains the view.

  Args:
    indptr / indices / blocks128 / seeds / seed_mask / k / key / meta: as
      ``sample_hop_fused`` (``seeds`` is this level's frontier;
      ``blocks128`` must be None).
    state: the ``MergeInducerState`` before this level; its node buffer
      is updated in place.
    src_idx: frontier local indices (edge source relabel).
    prefix_cap: static occupancy bound before this level.
    max_new: static clamp on nodes kept (the plan's next-hop cap).
    final: the last level induced on this state.

  Returns ``(state', out, safe_epos, mask)`` with ``out`` the
  ``induce_next_merge`` output dict. No host sync: ``out['num_new']`` is
  a 0-d device tensor.
  """
  if blocks128 is not None:
    raise ValueError('the port reads the flat indices: pass blocks128=None')
  f = seeds.shape[0]
  size = f * k
  cap = state.nodes.shape[0]
  c = min(prefix_cap, cap)
  limit = min(size, cap - c, size if max_new is None else max_new)
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)

  if indices.device.type == 'cpu':
    nbrs = torch.where(mask, _pick(indices, safe_epos).reshape(f, k), FILL)
    state2, out = induce_next_merge(state, src_idx, nbrs, mask,
                                    prefix_cap=prefix_cap, max_new=max_new,
                                    update_view=not final)
    return state2, out, safe_epos, mask

  _, cols_raw, block, num_new = sample_level(
      indices, safe_epos, mask, state.nodes[:c], state.num_nodes, limit,
      indptr.shape[0] - 1)
  state2, out = level_epilogue(state, src_idx, mask, cols_raw, block,
                               num_new, c)
  return state2, out, safe_epos, mask


def level_epilogue(state: MergeInducerState, src_idx, mask, cols_raw, block,
                   num_new, c: int):
  """The JAX kernel path's epilogue
  (``graphlearn_tpu/ops/sample_fused.py:620-644``) over
  the level kernel's outputs: truncation mask, edge rows, the node
  append at ``num_nodes`` (in place) and the FILL-padded frontier. The
  sorted view is passed through stale. Returns ``(state', out)``."""
  f, k = mask.shape
  limit = block.shape[0]
  cap = state.nodes.shape[0]
  num_nodes = state.num_nodes
  num_kept = torch.clamp(num_new, max=limit)
  emask = mask.reshape(-1) & (cols_raw >= 0) & \
      (cols_raw < num_nodes + num_kept)
  cols = torch.where(emask, cols_raw, -1)
  rows = torch.where(emask, repeat_each(src_idx, k), -1)
  # clamped-growth invariant (induce_merge.append_block): limit <= cap - c
  # and num_nodes <= c, so the append at num_nodes stays in bounds
  assert 0 <= limit <= cap - c, (limit, cap, c)
  nodes = append_block(state.nodes, block.to(state.nodes.dtype), num_nodes)
  frontier, frontier_idx, fin = merge_frontier(block, f * k, num_nodes,
                                               num_kept)
  out = dict(rows=rows, cols=cols, edge_mask=emask, frontier=frontier,
             frontier_idx=frontier_idx, frontier_mask=fin, num_new=num_new)
  return MergeInducerState(nodes, num_nodes + num_kept, state.sorted_ids,
                           state.sorted_loc), out
