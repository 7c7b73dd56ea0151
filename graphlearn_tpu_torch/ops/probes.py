"""The measurement probes' kernels: a row gather by bulk copies and a take
from a table held in shared memory.

Counterparts of the two Pallas probes of the JAX package's benchmark
suites, which the port's probe suites (``graphlearn_tpu_torch.
benchmarks.prof_mem`` / ``prof_dedup``) time:

- ``row_gather_probe``: ``benchmarks/prof_mem.py`` ``pallas_row_gather``
  (one grid step per output row, the row picked by a scalar-prefetched
  index). On a CUDA tensor the wrapper launches
  ``csrc/row_gather_probe.cu`` on one of two routes, chosen by shape
  (``row_gather_route``): the bulk route (persistent CTAs, each row one
  bulk copy in and one out through a ring in shared memory) when the row
  bytes and both base pointers are 16-byte aligned, else the vector route
  (the same persistent CTAs, rows copied by warps). Each route has its
  launch counter. The TPU probe leaves an id outside ``[0, N)``
  undefined; the port clamps it, as ``gather_rows_hbm`` does.
- ``smem_take``: ``benchmarks/prof_dedup.py`` ``pk``, ``jnp.take`` from a
  table held in on-chip memory, in jnp.take's default fill mode: an id in
  ``[-TN, 0)`` counts from the end, any other id outside ``[0, TN)``
  gives ``INT32_MIN``. On a CUDA tensor the wrapper launches
  ``csrc/smem_take.cu`` (a thread-block cluster of 2, 4 or 8 CTAs, each
  holding its part of the table in shared memory).

On CPU tensors both wrappers run their plain versions.
"""
import torch

from . import kernels
from .gather import _check, gather_rows_plain

# launches of the CUDA kernels (plain-version calls do not count), the
# row gather's per route
row_gather_bulk_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
row_gather_vector_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
smem_take_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]

FILL = -2 ** 31
# the cluster sizes smem_take takes, and the one it launches by default
SMEM_TAKE_CLUSTERS = (2, 4, 8)
SMEM_TAKE_CLUSTER = 2
# a CTA holds at most 227 KB (232,448 B) of shared memory: int32 entries
# per CTA, and the largest table the default cluster holds
_SMEM_ROWS_PER_CTA = 232_448 // 4
SMEM_TAKE_MAX_ROWS = SMEM_TAKE_CLUSTER * _SMEM_ROWS_PER_CTA


def row_gather_probe_plain(table: torch.Tensor, ids: torch.Tensor):
  """``table[clip(ids, 0, N-1)]`` in plain torch (any device)."""
  return gather_rows_plain(table, ids)


def row_gather_route(table: torch.Tensor, out: torch.Tensor = None) -> str:
  """The route ``row_gather_probe`` takes for ``table`` (and ``out``):
  'bulk' when a row's bytes and both base pointers are multiples of 16
  (what a bulk copy needs), else 'vector'."""
  row_bytes = table.shape[1] * table.element_size()
  ptrs = table.data_ptr() | (0 if out is None else out.data_ptr())
  return 'bulk' if row_bytes % 16 == 0 and ptrs % 16 == 0 else 'vector'


def row_gather_probe(table: torch.Tensor, ids: torch.Tensor):
  """Gather ``table[ids]`` rows (ids clamped to ``[0, N)``); on the card
  by bulk copies where ``row_gather_route`` allows, else by warps.

  Args:
    table: ``[N, F]`` float32 / bfloat16 / float16 / int32, contiguous.
    ids: ``[B]`` int32 or int64 on the table's device.
  """
  if table.device.type == 'cpu' and ids.device.type == 'cpu':
    return row_gather_probe_plain(table, ids)
  _check(table, ids, 'row_gather_probe')
  global row_gather_bulk_launches, row_gather_vector_launches
  out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                    device=table.device)
  if ids.shape[0] == 0:
    return out
  bulk = row_gather_route(table, out) == 'bulk'
  err = kernels.lib('row_gather_probe').glt_row_gather_probe(
      table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
      out.data_ptr(), table.shape[0], ids.shape[0],
      table.shape[1] * table.element_size(), int(bulk),
      table.device.index or 0,
      torch.cuda.current_stream(table.device).cuda_stream)
  kernels.check(err, 'row_gather_probe')
  if bulk:
    with kernels.COUNT_LOCK:
      row_gather_bulk_launches += 1
  else:
    with kernels.COUNT_LOCK:
      row_gather_vector_launches += 1
  return out


def smem_take_plain(table: torch.Tensor, idx: torch.Tensor):
  """``jnp.take(table, idx)`` (fill mode) in plain torch: ids in
  ``[-TN, 0)`` wrap, other ids outside ``[0, TN)`` give ``INT32_MIN``."""
  tn = table.shape[0]
  if tn == 0:
    return torch.full_like(idx, FILL, dtype=table.dtype)
  i = idx.long()
  i = torch.where(i < 0, i + tn, i)
  ok = (i >= 0) & (i < tn)
  got = table[i.clamp(0, tn - 1)]
  return torch.where(ok, got, torch.full_like(got, FILL))


def smem_take(table: torch.Tensor, idx: torch.Tensor,
              cluster: int = SMEM_TAKE_CLUSTER):
  """``take(table, idx)`` in fill mode, the table held in the shared
  memory of a thread-block cluster on the card.

  Args:
    table: ``[TN]`` int32, contiguous, ``1 <= TN <= cluster * 58,112``
      (``SMEM_TAKE_MAX_ROWS`` at the default cluster).
    idx: int32 ids of any shape, contiguous, on the table's device.
    cluster: CTAs in the cluster that holds the table, one of
      ``SMEM_TAKE_CLUSTERS``.

  Returns an int32 tensor of ``idx``'s shape.
  """
  if cluster not in SMEM_TAKE_CLUSTERS:
    raise ValueError(f'smem_take: cluster {cluster} is not one of '
                     f'{SMEM_TAKE_CLUSTERS}')
  if table.device.type == 'cpu' and idx.device.type == 'cpu':
    return smem_take_plain(table, idx)
  if table.device.type != 'cuda' or idx.device != table.device:
    raise ValueError(f'smem_take: table on {table.device} and ids on '
                     f'{idx.device}; the kernel needs both on one CUDA '
                     'device')
  if table.dim() != 1 or table.dtype != torch.int32 or \
      idx.dtype != torch.int32:
    raise ValueError(f'smem_take: needs a 1-D int32 table and int32 ids, '
                     f'got {tuple(table.shape)} {table.dtype}, {idx.dtype}')
  most = cluster * _SMEM_ROWS_PER_CTA
  if not 1 <= table.shape[0] <= most:
    raise ValueError(f'smem_take: a table of {table.shape[0]} entries; the '
                     f'cluster holds 1 to {most}')
  if not (table.is_contiguous() and idx.is_contiguous()):
    raise ValueError('smem_take: table and ids must be contiguous')
  global smem_take_launches
  out = torch.empty_like(idx)
  if idx.numel() == 0:
    return out
  err = kernels.lib('smem_take').glt_smem_take(
      table.data_ptr(), table.shape[0], idx.data_ptr(), out.data_ptr(),
      idx.numel(), cluster, table.device.index or 0,
      torch.cuda.current_stream(table.device).cuda_stream)
  kernels.check(err, 'smem_take')
  with kernels.COUNT_LOCK:
    smem_take_launches += 1
  return out
