"""Row gather from a device-resident table: the feature lookup.

Counterpart of ``graphlearn_tpu/ops/gather_pallas.py`` v1
(``gather_rows_hbm``). On a CUDA tensor the wrapper launches the
``csrc/gather_rows.cu`` kernel (one warp per output row); on a CPU
tensor it runs the plain version. Both clamp ids to ``[0, N)``.
"""
import torch

from . import kernels

# launches of the CUDA kernel (plain-version calls do not count)
launches = 0

_ROW_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor):
  """``table[clip(ids, 0, N-1)]`` in plain torch (any device)."""
  return table[ids.clamp(0, table.shape[0] - 1).long()]


def gather_rows_hbm(table: torch.Tensor, ids: torch.Tensor):
  """Gather ``table[ids]`` rows, ids clamped to ``[0, N)``.

  Args:
    table: ``[N, F]`` float32 / bfloat16 / float16 / int32, contiguous.
    ids: ``[B]`` int32 or int64 on the table's device.

  Returns ``[B, F]`` rows of ``table``'s dtype.
  """
  if table.device.type == 'cpu' and ids.device.type == 'cpu':
    return gather_rows_plain(table, ids)
  _check(table, ids)
  global launches
  out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                    device=table.device)
  if ids.shape[0] == 0:
    return out
  err = kernels.lib('gather_rows').glt_gather_rows(
      table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
      out.data_ptr(), table.shape[0], ids.shape[0],
      table.shape[1] * table.element_size(), table.device.index or 0,
      torch.cuda.current_stream(table.device).cuda_stream)
  kernels.check(err, 'gather_rows')
  launches += 1
  return out


def _check(table, ids):
  if table.device.type != 'cuda' or ids.device != table.device:
    raise ValueError(f'gather_rows_hbm: table on {table.device} and ids on '
                     f'{ids.device}; the kernel needs both on one CUDA '
                     'device')
  if table.dim() != 2 or table.dtype not in _ROW_DTYPES:
    raise ValueError(f'gather_rows_hbm: table must be 2-D of '
                     f'{_ROW_DTYPES}, got {tuple(table.shape)} '
                     f'{table.dtype}')
  if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
    raise ValueError(f'gather_rows_hbm: ids must be 1-D int32/int64, got '
                     f'{tuple(ids.shape)} {ids.dtype}')
  if not (table.is_contiguous() and ids.is_contiguous()):
    raise ValueError('gather_rows_hbm: table and ids must be contiguous')
  if table.shape[0] == 0 and ids.shape[0] > 0:
    raise ValueError('gather_rows_hbm: gather from an empty table')
