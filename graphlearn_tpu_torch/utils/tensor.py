"""Small tensor helpers (the port's copy of ``graphlearn_tpu/utils/
tensor.py``): numpy in, numpy out, torch tensors accepted."""
from typing import Any, Dict, Optional, Union

import numpy as np


def id2idx(ids: np.ndarray, max_id: Optional[int] = None) -> np.ndarray:
  """Dense inverse map ``out[ids[i]] = i``; ids not present map to 0
  (callers mask by membership)."""
  ids = np.asarray(ids)
  if max_id is None:
    max_id = int(ids.max(initial=-1)) + 1
  out = np.zeros(max_id, dtype=np.int64)
  out[ids] = np.arange(ids.shape[0], dtype=np.int64)
  return out


def convert_to_array(data: Any, dtype=None) -> Any:
  """Recursively convert python, list and torch data to numpy arrays."""
  if data is None:
    return None
  if isinstance(data, dict):
    return {k: convert_to_array(v, dtype) for k, v in data.items()}
  if hasattr(data, 'detach'):
    data = data.detach().cpu().numpy()
  arr = np.asarray(data)
  if dtype is not None:
    arr = arr.astype(dtype, copy=False)
  return arr


def squeeze_dict(data: Union[Dict, Any]) -> Any:
  """Unwrap a single-entry dict."""
  if isinstance(data, dict) and len(data) == 1:
    return next(iter(data.values()))
  return data
