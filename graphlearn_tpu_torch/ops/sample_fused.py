"""Fused CSR hop (sample + gather), and the fused merge level (sample +
gather + exact dedup).

Counterpart of ``graphlearn_tpu/ops/sample_fused.py``
(``sample_hop_fused``, ``sample_level_fused``). On CUDA tensors each is
the port's kernel with the threefry draw inside it (``csrc/csr_pick.cuh``,
bit for bit the JAX package's stream):

- ``sample_hop_fused``: one launch of ``csrc/sample_hop.cu`` per hop.
- ``sample_level_fused``: three launches of ``csrc/sample_level.cu`` per
  level (pick, scan, resolve) over a ``LevelScratch`` that carries the
  batch's node-id hash table across its levels, plus one launch per batch
  (``LevelScratch.begin``).

Both read the key from device memory: a host key is uploaded once per
call (the sampler uploads one ``[n_hops, 2]`` tensor per batch and passes
its rows). On CPU tensors they run their plain versions:
``ops.uniform_sample`` and ``sample_level_fused_plain`` (the draw, torch
indexing and the merge inducer).

The JAX kernels read a ``[ceil(E/128), 128]`` lane-aligned view of the
indices (``build_indices128``), a TPU layout. The port reads the flat
``[E]`` indices, so ``blocks128`` must be None here, and it takes no
``window``: the JAX kernels' segment staging has no counterpart (see
``csrc/sample_hop.cu``).
"""
import torch

from .. import random as trandom
from . import kernels
from .induce_merge import MergeInducerState, induce_next_merge
from .neighbor import _seed_rows, pick, uniform_sample
from .unique import FILL

# launches of the CUDA kernels (plain-version calls do not count):
# ``launches`` counts the hop kernel, ``level_launches`` every launch of
# the level kernel's library (begin, pick, scan, resolve)
launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
level_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]


def _on_cpu(*tensors) -> bool:
  return all(t.device.type == 'cpu' for t in tensors)


def _check(what, dev, tensors):
  """Every ``(name, tensor, dtype, shape)`` contiguous on the CUDA device
  ``dev`` with that dtype and shape (None in a shape: any size)."""
  if dev.type != 'cuda' or any(t.device != dev for _, t, _, _ in tensors):
    raise ValueError(f'{what}: every tensor must lie on one CUDA device')
  for name, t, dtype, shape in tensors:
    if t.dtype != dtype or t.dim() != len(shape) or not t.is_contiguous() \
        or any(s is not None and s != n for s, n in zip(shape, t.shape)):
      raise ValueError(f'{what}: {name} must be a contiguous {dtype} tensor '
                       f'of shape {shape}, got {tuple(t.shape)} {t.dtype}')


def _kernel_inputs(what, indptr, indices, seeds, seed_mask, key, meta):
  """Checked kernel arguments: ``(seeds or None, rows [R, 2], key)``. With
  ``meta`` the kernel reads each seed's row of the ``[N, 2]`` table; with
  None the two ``indptr`` reads run in torch and the kernel reads one row
  per seed. A host key is uploaded."""
  dev = indices.device
  b = seeds.shape[0]
  table = ('meta', meta, torch.int32, (None, 2)) if meta is not None else \
      ('indptr', indptr, torch.int32, (None,))
  _check(what, dev, (('indices', indices, torch.int32, (None,)),
                     ('seeds', seeds, torch.int32, (b,)),
                     ('seed_mask', seed_mask, torch.bool, (b,)), table))
  key = torch.as_tensor(key)
  if key.device != dev:
    key = trandom.to_device(key, dev)
  _check(what, dev, (('key', key, torch.int64, (2,)),))
  if meta is not None:
    if meta.shape[0] == 0:
      raise ValueError(f'{what}: empty row table')
    return seeds, meta, key
  start, deg = _seed_rows(indptr, None, seeds, seed_mask)
  return None, torch.stack([start, deg], 1), key


def _stream(dev):
  return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
  return None if t is None else t.data_ptr()


def sample_hop_fused(indptr, indices, blocks128, seeds, seed_mask, k: int,
                     key, meta=None):
  """One uniform CSR hop; the output contract and PRNG stream of
  ``ops.uniform_sample``.

  Args:
    indptr / indices: the CSR (``indptr`` is read when ``meta`` is None).
    blocks128: must be None (the port reads the flat indices).
    seeds / seed_mask: ``[B]`` int32 / bool.
    k: fanout. key: threefry key (``random.PRNGKey`` family), on the host
      or on the tensors' device.
    meta: optional ``[N, 2]`` (start, degree) row table.

  Returns ``(nbrs [B, k] FILL-padded, epos [B, k] 0-padded, mask [B, k])``.
  On CUDA tensors: one launch of the hop kernel, no host sync.
  """
  if blocks128 is not None:
    raise ValueError('the port reads the flat indices: pass blocks128=None')
  if _on_cpu(indices, seeds, seed_mask):
    return uniform_sample(indptr, indices, seeds, seed_mask, k, key, meta)
  global launches
  seeds_arg, rows, key = _kernel_inputs('sample_hop_fused', indptr, indices,
                                        seeds, seed_mask, key, meta)
  dev = indices.device
  b = seeds.shape[0]
  nbrs = torch.empty((b, k), dtype=torch.int32, device=dev)
  epos = torch.empty((b, k), dtype=torch.int32, device=dev)
  mask = torch.empty((b, k), dtype=torch.bool, device=dev)
  if b * k == 0:
    return nbrs, epos, mask
  err = kernels.lib('sample_hop').glt_sample_hop_fused(
      _ptr(seeds_arg), seed_mask.data_ptr(), rows.data_ptr(), rows.shape[0],
      indices.data_ptr(), indices.shape[0], key.data_ptr(), b, k,
      nbrs.data_ptr(), epos.data_ptr(), mask.data_ptr(), *_stream(dev))
  kernels.check(err, 'sample_hop')
  with kernels.COUNT_LOCK:
    launches += 1
  return nbrs, epos, mask


def sample_level_plain(indices, safe_epos, mask, nodes_prefix, num_nodes,
                       limit: int, num_graph_nodes: int):
  """One merge level's relabel map from given picks, in plain torch (any
  device): the function of the JAX level kernel's raw outputs
  (``_level_pallas``), computed without the merge inducer's sorts.

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
  (impossible from a CSR of N rows) get column -1.
  """
  picked = pick(indices, safe_epos.reshape(-1))
  valid = mask.reshape(-1)
  dev = picked.device
  c = nodes_prefix.shape[0]
  pos = torch.arange(c, dtype=torch.int32, device=dev)
  occupied = (pos < num_nodes) & (nodes_prefix >= 0)
  order = torch.argsort(nodes_prefix[occupied], stable=True)
  sids, spos = nodes_prefix[occupied][order], pos[occupied][order]
  # last equal entry = the largest position, as the level kernel's table
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


class LevelScratch:
  """The level kernel's scratch for batches whose node buffer holds
  ``capacity`` slots, over a graph of ``num_graph_nodes`` nodes: the
  node-id hash table (2x the capacity or more, a power of two), the id
  bitmap and its scan's bases. Made zeroed once; ``begin`` (one launch)
  clears the table and the bitmap and inserts the buffer's occupied
  prefix at the start of every batch, and each level's scan leaves the
  bitmap clear for the next. One batch at a time uses it."""

  def __init__(self, num_graph_nodes: int, capacity: int, device):
    if not 0 < num_graph_nodes < 2 ** 31 or not 0 <= capacity <= 2 ** 29:
      raise ValueError(f'sample_level_fused: {num_graph_nodes} graph nodes '
                       f'or a buffer of {capacity} slots out of range')
    self.num_graph_nodes = int(num_graph_nodes)
    self.capacity = int(capacity)
    words = kernels.lib('sample_level').glt_level_scratch_words(
        self.num_graph_nodes, self.capacity)
    self.buf = torch.zeros(words, dtype=torch.int32, device=device)
    self.device = self.buf.device

  def begin(self, state: MergeInducerState, prefix_len: int):
    """Start a batch from ``state``: its buffer positions ``j <
    min(prefix_len, num_nodes)`` go into the table."""
    global level_launches
    _check('LevelScratch.begin', self.device, (
        ('nodes', state.nodes, torch.int32, (self.capacity,)),
        ('num_nodes', state.num_nodes, torch.int32, ())))
    err = kernels.lib('sample_level').glt_level_begin(
        self.buf.data_ptr(), self.num_graph_nodes, self.capacity,
        state.nodes.data_ptr(), min(prefix_len, self.capacity),
        state.num_nodes.data_ptr(), *_stream(self.device))
    kernels.check(err, 'sample_level begin')
    with kernels.COUNT_LOCK:
      level_launches += 1
    return self


def sample_level_fused_plain(indptr, indices, seeds, seed_mask, k: int, key,
                             state: MergeInducerState, src_idx, meta=None, *,
                             prefix_cap: int, max_new=None,
                             final: bool = False):
  """``sample_level_fused``'s plain version (any device): the hop of
  ``ops.uniform_sample`` and ``ops.induce_next_merge`` (the JAX package's
  fallback), which also maintains the sorted view."""
  nbrs, safe_epos, mask = uniform_sample(indptr, indices, seeds, seed_mask,
                                         k, key, meta)
  state2, out = induce_next_merge(state, src_idx, nbrs, mask,
                                  prefix_cap=prefix_cap, max_new=max_new,
                                  update_view=not final)
  return state2, out, safe_epos, mask


def sample_level_fused(indptr, indices, blocks128, seeds, seed_mask, k: int,
                       key, state: MergeInducerState, src_idx, meta=None, *,
                       prefix_cap: int, max_new=None, final: bool = False,
                       scratch: LevelScratch = None):
  """One whole fanout level of the merge engine (sample, gather, exact
  dedup), equal to ``ops.uniform_sample`` followed by
  ``ops.induce_next_merge``.

  On CUDA tensors: three launches of the level kernel, no host sync. The
  sorted view is passed through stale, as on the TPU (no later level
  reads it there). ``scratch`` is the batch's ``LevelScratch`` after its
  ``begin`` and the batch's earlier levels; without one, a scratch is
  made and begun from ``state`` (one more launch). On CPU tensors:
  ``sample_level_fused_plain``.

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
  ``induce_next_merge`` output dict; ``out['num_new']`` is a 0-d device
  tensor.
  """
  if blocks128 is not None:
    raise ValueError('the port reads the flat indices: pass blocks128=None')
  if _on_cpu(indices, seeds, seed_mask, state.nodes):
    return sample_level_fused_plain(
        indptr, indices, seeds, seed_mask, k, key, state, src_idx, meta,
        prefix_cap=prefix_cap, max_new=max_new, final=final)
  global level_launches
  f = seeds.shape[0]
  size = f * k
  cap = state.nodes.shape[0]
  c = min(prefix_cap, cap)
  limit = min(size, cap - c, size if max_new is None else max_new)
  # clamped-growth invariant (induce_merge.append_block): limit <= cap - c
  # and num_nodes <= c, so the append at num_nodes stays in bounds
  assert 0 <= limit <= cap - c, (limit, cap, c)
  seeds_arg, rows, key = _kernel_inputs('sample_level_fused', indptr,
                                        indices, seeds, seed_mask, key, meta)
  dev = indices.device
  _check('sample_level_fused', dev, (
      ('src_idx', src_idx, torch.int32, (f,)),
      ('nodes', state.nodes, torch.int32, (cap,)),
      ('num_nodes', state.num_nodes, torch.int32, ())))
  n = indptr.shape[0] - 1
  if scratch is None:
    scratch = LevelScratch(n, cap, dev).begin(state, c)
  elif (scratch.num_graph_nodes, scratch.capacity, scratch.device) != \
      (n, cap, dev):
    raise ValueError('sample_level_fused: the scratch was made for another '
                     'graph, capacity or device')
  epos = torch.empty((f, k), dtype=torch.int32, device=dev)
  mask = torch.empty((f, k), dtype=torch.bool, device=dev)
  cols, erows, frontier, fidx = (
      torch.empty(size, dtype=torch.int32, device=dev) for _ in range(4))
  emask, fmask = (torch.empty(size, dtype=torch.bool, device=dev)
                  for _ in range(2))
  counts = torch.empty(2, dtype=torch.int32, device=dev)
  err = kernels.lib('sample_level').glt_level_run(
      scratch.buf.data_ptr(), n, cap, _ptr(seeds_arg), seed_mask.data_ptr(),
      rows.data_ptr(), rows.shape[0], indices.data_ptr(), indices.shape[0],
      key.data_ptr(), f, k, src_idx.data_ptr(), state.nodes.data_ptr(),
      state.num_nodes.data_ptr(), limit, int(not final), epos.data_ptr(),
      mask.data_ptr(), cols.data_ptr(), erows.data_ptr(), emask.data_ptr(),
      frontier.data_ptr(), fidx.data_ptr(), fmask.data_ptr(),
      counts.data_ptr(), *_stream(dev))
  kernels.check(err, 'sample_level')
  with kernels.COUNT_LOCK:
    level_launches += 3
  out = dict(rows=erows, cols=cols, edge_mask=emask, frontier=frontier,
             frontier_idx=fidx, frontier_mask=fmask, num_new=counts[0])
  return MergeInducerState(state.nodes, counts[1], state.sorted_ids,
                           state.sorted_loc), out, epos, mask
