"""Device-resident feature table: the all-hot part of UnifiedTensor.

Counterpart of ``graphlearn_tpu/data/unified_tensor.py`` for tables that
live wholly on the device. Row lookups clamp ids to ``[0, N)`` and go
through the row-gather kernel on a CUDA table, or through the
run-segmented gather-v2 kernel when ``use_pallas_v2`` is set (off by
default, as in the JAX package; ``Feature.set_kernel_routing`` sets it).
The host/cold split (rows read over UVA from pinned host memory, the
reference's own design) is a later slice.
"""
import numpy as np
import torch

from ..ops.gather import gather_rows_hbm, gather_rows_hbm2


class UnifiedTensor:
  """A ``[N, F]`` table on ``device``."""

  # opt-in routing through the run-segmented gather (ops.gather_rows_hbm2)
  # at its grid point; the names are the JAX package's
  use_pallas_v2 = False
  pallas_v2_block_rows = 256
  pallas_v2_run_span = 8

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
    if self.use_pallas_v2:
      return gather_rows_hbm2(self._device_part, ids.contiguous(),
                              block_rows=self.pallas_v2_block_rows,
                              run_span=self.pallas_v2_run_span)
    return gather_rows_hbm(self._device_part, ids.contiguous())
