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

  @property
  def unified(self) -> UnifiedTensor:
    return self._unified

  def __getitem__(self, ids) -> torch.Tensor:
    """Rows for global node ids. FILL (-1) slots read storage row 0,
    after the id2index remap, as in the JAX package."""
    ids = torch.as_tensor(ids, device=self.device).long()
    pad = ids < 0
    idx = torch.clamp(ids, min=0)
    if self._id2index_dev is not None:
      idx = self._id2index_dev[idx].long()
    idx = torch.where(pad, 0, idx)
    return self._unified[idx]

  def device_table(self):
    """``(feats, id2index)`` on the device, for the fused collate."""
    return self._unified.device_part, self._id2index_dev

  @property
  def shape(self):
    return tuple(self._unified.device_part.shape)

  def __len__(self):
    return int(self._unified.device_part.shape[0])
