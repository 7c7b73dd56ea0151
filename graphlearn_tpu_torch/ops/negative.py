"""Fixed-shape random negative edge sampling.

Counterpart of ``graphlearn_tpu/ops/negative.py``: draw ``trials *
num_samples`` candidate (row, col) pairs with ``jax.random.randint``'s
stream, reject the pairs present in the CSR by binary search, and keep
the first ``num_samples`` survivors in draw order (then the first
rejected ones), with no host sync.

On CUDA tensors the draw and the membership test are one launch of
``csrc/negative_sample.cu``; the stable partition and the take stay in
torch (a cumsum scatter). On CPU tensors the plain version runs:
``random.randint`` (the uint32 emulation), ``ops.edge_in_csr`` and the
same partition. Nothing falls back: a failed build or launch raises.

``random_negative_sample_local`` is the distributed engine's shard-local
draw: on CUDA tensors one launch of the kernel's second entry, which
also counts the shard's owned rows itself (JAX's device value
``num_rows``), so a distributed link batch makes no host sync.
"""
import numpy as np
import torch

from .. import random as trandom
from . import kernels
from .neighbor import edge_in_csr

# launches of the CUDA kernel (plain-version calls do not count)
launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
# launches of its shard-local entry
local_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]

INT32_MAX = 2 ** 31 - 1


def sort_csr_segments(indptr: np.ndarray, indices: np.ndarray):
  """Host-side: sort ``indices`` within each row segment (binary-search
  membership requires sorted rows). Returns ``(sorted_indices, perm)``
  where ``perm`` maps sorted edge positions back to CSR positions."""
  indptr = np.asarray(indptr)
  indices = np.asarray(indices)
  rows = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
  perm = np.lexsort((indices, rows))
  return indices[perm], perm


def sort_csr_rows(indptr, indices):
  """``sort_csr_segments``' sorted indices, computed on the CSR's device
  (one sort of the int64 keys ``row << 32 | index``): ``[E]`` int32. A
  sort fixes the values (ties are equal values), so they equal the host
  function's."""
  n = indptr.shape[0] - 1
  e = indices.shape[0]
  counts = (indptr[1:] - indptr[:-1]).to(torch.int64)
  rows = torch.repeat_interleave(
      torch.arange(n, dtype=torch.int64, device=indices.device), counts,
      output_size=e)
  key = (rows << 32) | indices.to(torch.int64)
  return (torch.sort(key).values & 0xFFFFFFFF).to(torch.int32)


def _span(lo: int, hi: int) -> int:
  """``randint``'s span of ``[lo, hi)`` (1 for an empty range)."""
  return hi - lo if hi > lo else 1


def negative_candidates_plain(indptr, sorted_indices, num_src: int,
                              num_dst: int, total: int, key):
  """``(rows, cols, valid)`` of ``total`` candidates in plain torch on the
  CSR's device: ``kr, kc = split(key)``, ``randint`` of each, and the
  membership test (``valid``: not an edge)."""
  dev = sorted_indices.device
  kr, kc = trandom.split(torch.as_tensor(key))
  rows = trandom.randint(kr, (total,), 0, num_src, dev)
  cols = trandom.randint(kc, (total,), 0, num_dst, dev)
  return rows, cols, ~edge_in_csr(indptr, sorted_indices, rows, cols)


def negative_candidates(indptr, sorted_indices, num_src: int, num_dst: int,
                        total: int, key):
  """:func:`negative_candidates_plain`'s outputs from one launch of the
  kernel on CUDA tensors (no host sync; a host key is uploaded without
  blocking), or from the plain version on CPU tensors."""
  global launches
  dev = sorted_indices.device
  if dev.type == 'cpu' and indptr.device.type == 'cpu':
    return negative_candidates_plain(indptr, sorted_indices, num_src,
                                     num_dst, total, key)
  if dev.type != 'cuda' or indptr.device != dev:
    raise ValueError('random_negative_sample: indptr and sorted_indices '
                     'must lie on one CUDA device')
  for name, t in (('indptr', indptr), ('sorted_indices', sorted_indices)):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
      raise ValueError(f'random_negative_sample: {name} must be a '
                       f'contiguous 1-d int32 tensor, got '
                       f'{tuple(t.shape)} {t.dtype}')
  key = torch.as_tensor(key)
  if key.device != dev:
    key = trandom.to_device(key, dev)
  if key.dtype != torch.int64 or key.shape != (2,) or \
      not key.is_contiguous():
    raise ValueError(f'random_negative_sample: needs a contiguous [2] '
                     f'int64 key, got {tuple(key.shape)} {key.dtype}')
  rows = torch.empty(total, dtype=torch.int32, device=dev)
  cols = torch.empty(total, dtype=torch.int32, device=dev)
  valid = torch.empty(total, dtype=torch.bool, device=dev)
  if total == 0:
    return rows, cols, valid
  err = kernels.lib('negative_sample').glt_negative_sample(
      key.data_ptr(), indptr.data_ptr(), indptr.shape[0],
      sorted_indices.data_ptr(), sorted_indices.shape[0],
      _span(0, int(num_src)), _span(0, int(num_dst)), total,
      rows.data_ptr(), cols.data_ptr(), valid.data_ptr(), dev.index or 0,
      torch.cuda.current_stream(dev).cuda_stream)
  kernels.check(err, 'negative_sample')
  with kernels.COUNT_LOCK:
    launches += 1
  return rows, cols, valid


def take_negatives(rows, cols, valid, num_samples: int,
                   padding: bool = False):
  """The first ``num_samples`` candidates of the stable partition (valid
  first, each part in draw order), the order of
  ``jnp.argsort(jnp.where(valid, 0, 1), stable=True)``, placed by a
  cumsum scatter instead of a sort: a valid candidate goes to the number
  of valid ones before it, a rejected one after all the valid ones. With
  ``padding`` the mask is all true (a shortfall is filled with the first
  rejected candidates)."""
  n = valid.shape[0]
  pos = torch.arange(n, device=valid.device)
  before = torch.cumsum(valid, 0) - valid.long()   # valid ones before i
  dest = torch.where(valid, before, valid.sum() + pos - before)
  order = torch.empty_like(pos).scatter_(0, dest, pos)
  take = order[:num_samples]
  mask = valid[take]
  if padding:
    mask = torch.ones_like(mask)
  return rows[take], cols[take], mask


def random_negative_sample_plain(indptr, sorted_indices, num_src: int,
                                 num_dst: int, num_samples: int, key,
                                 trials: int = 5, padding: bool = False):
  """:func:`random_negative_sample` in plain torch on any device."""
  cand = negative_candidates_plain(indptr, sorted_indices, num_src, num_dst,
                                   num_samples * trials, key)
  return take_negatives(*cand, num_samples, padding)


def random_negative_sample(indptr, sorted_indices, num_src: int,
                           num_dst: int, num_samples: int, key,
                           trials: int = 5, padding: bool = False):
  """Sample ``num_samples`` (row, col) pairs absent from the CSR.

  Args:
    indptr / sorted_indices: ``[N + 1]`` / ``[E]`` int32 CSR with
      row-sorted indices (:func:`sort_csr_segments`).
    num_src / num_dst: id ranges of rows and cols.
    num_samples: pairs wanted; ``trials * num_samples`` candidates are
      drawn and tested.
    key: ``[2]`` threefry key, on the host or on the CSR's device.
    padding: non-strict mode: the mask is all true, and a shortfall is
      padded with rejected (positive) pairs.

  Returns ``(rows [num_samples] int32, cols [num_samples] int32, mask
  [num_samples] bool)``, equal to the JAX function's. On CUDA tensors:
  one kernel launch and the partition, no host sync.
  """
  cand = negative_candidates(indptr, sorted_indices, num_src, num_dst,
                             num_samples * trials, key)
  return take_negatives(*cand, num_samples, padding)


def local_candidates_plain(row_ids, indptr_loc, sorted_indices, num_dst: int,
                           total: int, key):
  """``(local rows, cols, not an edge, rows owned)`` of ``total``
  shard-local candidates in plain torch on the CSR's device: ``kr, kc =
  split(key)``, the row ``randint(kr, 0, 2**30) % max(owned, 1)`` (a
  local row index), the column ``randint(kc, 0, num_dst)`` and the
  membership test against the local CSR. ``owned`` is the count of
  ``row_ids`` that are not INT32_MAX padding (a 0-d int32 tensor)."""
  dev = sorted_indices.device
  owned = (row_ids != INT32_MAX).sum().to(torch.int32)
  kr, kc = trandom.split(torch.as_tensor(key))
  u = (trandom.randint(kr, (total,), 0, 2 ** 30, dev).to(torch.int64)
       % owned.clamp(min=1).to(torch.int64)).to(torch.int32)
  cols = trandom.randint(kc, (total,), 0, num_dst, dev)
  return u, cols, ~edge_in_csr(indptr_loc, sorted_indices, u, cols), owned


def local_candidates(row_ids, indptr_loc, sorted_indices, num_dst: int,
                     total: int, key):
  """:func:`local_candidates_plain`'s outputs from one launch of the
  kernel's shard-local entry on CUDA tensors (the owned-row count read
  on the device, no host sync), or from the plain version on CPU
  tensors."""
  global local_launches
  dev = sorted_indices.device
  if all(t.device.type == 'cpu' for t in (row_ids, indptr_loc,
                                          sorted_indices)):
    return local_candidates_plain(row_ids, indptr_loc, sorted_indices,
                                  num_dst, total, key)
  for name, t in (('row_ids', row_ids), ('indptr', indptr_loc),
                  ('sorted_indices', sorted_indices)):
    if t.device != dev or dev.type != 'cuda':
      raise ValueError('random_negative_sample_local: row_ids, indptr and '
                       'sorted_indices must lie on one CUDA device')
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
      raise ValueError(f'random_negative_sample_local: {name} must be a '
                       f'contiguous 1-d int32 tensor, got '
                       f'{tuple(t.shape)} {t.dtype}')
  key = torch.as_tensor(key)
  if key.device != dev:
    key = trandom.to_device(key, dev)
  if key.dtype != torch.int64 or key.shape != (2,) or \
      not key.is_contiguous():
    raise ValueError(f'random_negative_sample_local: needs a contiguous '
                     f'[2] int64 key, got {tuple(key.shape)} {key.dtype}')
  u = torch.empty(total, dtype=torch.int32, device=dev)
  cols = torch.empty(total, dtype=torch.int32, device=dev)
  valid = torch.empty(total, dtype=torch.bool, device=dev)
  owned = torch.empty((), dtype=torch.int32, device=dev)
  err = kernels.lib('negative_sample').glt_negative_sample_local(
      key.data_ptr(), row_ids.data_ptr(), row_ids.shape[0],
      indptr_loc.data_ptr(), indptr_loc.shape[0], sorted_indices.data_ptr(),
      sorted_indices.shape[0], _span(0, int(num_dst)), total, u.data_ptr(),
      cols.data_ptr(), valid.data_ptr(), owned.data_ptr(), dev.index or 0,
      torch.cuda.current_stream(dev).cuda_stream)
  kernels.check(err, 'negative_sample_local')
  with kernels.COUNT_LOCK:
    local_launches += 1
  return u, cols, valid, owned


def _finish_local(row_ids, cand, num_samples: int, strict: bool):
  """JAX's tail of ``random_negative_sample_local``: the first
  ``num_samples`` of the stable non-edge-first partition, valid where the
  shard owns rows (and, ``strict``, where the pair is no edge), mapped to
  global sources; -1 in invalid slots."""
  u, cols, notedge, owned = cand
  lu, lc, ok = take_negatives(u, cols, notedge, num_samples)
  valid = (owned > 0).expand(num_samples)
  if strict:
    valid = valid & ok
  src = torch.where(valid, row_ids[lu.long()].to(torch.int32), -1)
  return src, torch.where(valid, lc, -1), valid


def random_negative_sample_local_plain(row_ids, indptr_loc, sorted_indices,
                                       num_dst: int, num_samples: int, key,
                                       trials: int = 5,
                                       strict: bool = False):
  """:func:`random_negative_sample_local` in plain torch on any device."""
  cand = local_candidates_plain(row_ids, indptr_loc, sorted_indices,
                                num_dst, num_samples * trials, key)
  return _finish_local(row_ids, cand, num_samples, strict)


def random_negative_sample_local(row_ids, indptr_loc, sorted_indices,
                                 num_dst: int, num_samples: int, key,
                                 trials: int = 5, strict: bool = False):
  """Shard-local negative sampling of the distributed engine
  (``graphlearn_tpu/ops/negative.py:random_negative_sample_local``).

  The shard draws source rows from its own local CSR (``row_ids`` its
  ascending owned global ids, INT32_MAX-padded; ``indptr_loc`` /
  ``sorted_indices`` the local CSR with row-sorted indices) and columns
  in ``[0, num_dst)``; a candidate that is an edge of the local CSR is
  rejected. A row's out-edges all live on its owner, so the local test
  is complete for these sources. ``strict=False`` always emits
  ``num_samples`` pairs (a candidate that stayed an edge may slip
  through); ``strict=True`` marks such slots invalid. On a shard that
  owns no row every slot is invalid and its ids are -1.

  Returns ``(src [num_samples] global, dst [num_samples], valid
  [num_samples])``, equal to JAX's. On CUDA tensors: one kernel launch
  and the partition, no host sync."""
  cand = local_candidates(row_ids, indptr_loc, sorted_indices, num_dst,
                          num_samples * trials, key)
  return _finish_local(row_ids, cand, num_samples, strict)
