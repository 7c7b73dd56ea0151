"""Feature store with every row on the device.

Counterpart of ``graphlearn_tpu/data/feature.py:Feature`` with every
row on the device (``split_ratio=1.0``, the JAX Dataset's default). The
cold host tail is a later slice.
"""
from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device
from .unified_tensor import UnifiedTensor


def _fill_value(dtype):
  """``jnp.take``'s fill for an out-of-range row in its default mode."""
  if dtype.is_floating_point:
    return float('nan')
  return torch.iinfo(dtype).min


class Feature:
  """``[N, F]`` feature rows on ``device`` (None means the card).

  Args:
    feature_array: ``[N, F]`` host rows (already reordered when
      ``id2index`` is given).
    device: torch device for the table.
    id2index: optional ``[N]`` old-id -> row map.
    dtype: optional storage dtype (e.g. ``torch.bfloat16``).
  """

  def __init__(self, feature_array, device=None,
               id2index: Optional[np.ndarray] = None, dtype=None):
    feature_array = np.asarray(feature_array)
    self.device = resolve_device(device)
    self.dtype = dtype
    self._id2index = id2index
    self._unified = UnifiedTensor(self.device, dtype).init_from(
        feature_array)
    self._id2index_dev = (None if id2index is None else
                          torch.as_tensor(np.asarray(id2index)).to(
                              self.device))

  def set_kernel_routing(self, use_pallas_v2: bool = False,
                         block_rows: int = 256, run_span: int = 8):
    """Route the all-device lookup (``feature[ids]``) through the
    run-segmented gather (``ops.gather_rows_hbm2``) at the given grid
    point instead of the row-gather kernel. The loaders' fused collate
    gather is not routed, as in the JAX package."""
    self._unified.use_pallas_v2 = bool(use_pallas_v2)
    self._unified.pallas_v2_block_rows = int(block_rows)
    self._unified.pallas_v2_run_span = int(run_span)

  @property
  def unified(self) -> UnifiedTensor:
    return self._unified

  def __getitem__(self, ids) -> torch.Tensor:
    """Rows for global node ids. FILL (-1) slots read storage row 0,
    after the id2index remap, as in the JAX package. An id past the
    table (or past ``id2index``) gives the fill row of ``jnp.take``'s
    default mode: NaN for floats, the dtype's least value for integers."""
    ids = torch.as_tensor(ids, device=self.device).long()
    pad = ids < 0
    idx = torch.clamp(ids, min=0)
    oob = torch.zeros_like(pad)
    if self._id2index_dev is not None:
      remap = self._id2index_dev
      oob = idx >= remap.shape[0]
      idx = remap[torch.clamp(idx, max=remap.shape[0] - 1)].long()
    idx = torch.where(pad, 0, idx)
    n = self._unified.shape[0]
    oob = ~pad & (oob | (idx >= n) | (idx < -n))
    idx = torch.where(idx < 0, idx + n, idx)
    rows = self._unified[idx]
    return rows.masked_fill_(oob[:, None], _fill_value(rows.dtype))

  def device_table(self):
    """``(feats, id2index)`` on the device, for the fused collate."""
    return self._unified.device_part, self._id2index_dev

  @property
  def shape(self):
    return tuple(self._unified.device_part.shape)

  def __len__(self):
    return int(self._unified.device_part.shape[0])
