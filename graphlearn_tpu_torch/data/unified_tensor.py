"""Device-resident feature table: the all-hot part of UnifiedTensor.

Counterpart of ``graphlearn_tpu/data/unified_tensor.py`` for tables that
live wholly on the device. Row lookups clamp ids to ``[0, N)`` and go
through the row-gather kernel on a CUDA table. The host/cold split (rows
read over UVA from pinned host memory, the reference's own design) is a
later slice.
"""
import numpy as np
import torch

from ..ops.gather import gather_rows_hbm


class UnifiedTensor:
  """A ``[N, F]`` table on ``device``."""

  def __init__(self, device: torch.device, dtype=None):
    self.device = device
    self.dtype = dtype
    self._device_part = None

  def init_from(self, device_rows: np.ndarray):
    t = torch.as_tensor(np.ascontiguousarray(device_rows))
    if self.dtype is not None:
      t = t.to(self.dtype)
    self._device_part = t.to(self.device).contiguous()
    return self

  @property
  def device_part(self) -> torch.Tensor:
    return self._device_part

  @property
  def shape(self):
    return tuple(self._device_part.shape)

  def __getitem__(self, ids) -> torch.Tensor:
    ids = torch.as_tensor(ids, device=self.device)
    if ids.dtype not in (torch.int32, torch.int64):
      ids = ids.to(torch.int64)
    return gather_rows_hbm(self._device_part, ids.contiguous())
