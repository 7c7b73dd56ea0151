"""Host-side topology helpers and device resolution.

The CSR builders are the port's own copies of ``graphlearn_tpu/utils/
topo.py`` (numpy; same stable edge order, so ``indices`` match the JAX
package element for element).
"""
from typing import Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
  """``None`` means the card. Without one, raise instead of carrying on
  on the CPU: a caller that wants the CPU says ``device='cpu'``."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'graphlearn_tpu_torch runs on a CUDA device by default and none '
          "is available; pass device='cpu' to run on the CPU explicitly")
    return torch.device('cuda')
  return torch.device(device)


def ptr2ind(indptr: np.ndarray) -> np.ndarray:
  """Expand a CSR row pointer into per-edge row ids."""
  n = indptr.shape[0] - 1
  return np.repeat(np.arange(n, dtype=indptr.dtype), np.diff(indptr))


def ind2ptr(rows: np.ndarray, num_rows: int) -> np.ndarray:
  """CSR row pointer from *sorted* per-edge row ids."""
  counts = np.bincount(rows, minlength=num_rows)
  return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def coo_to_csr(row: np.ndarray, col: np.ndarray,
               num_nodes: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """COO -> (indptr, indices, order); edges keep their input order within
  a row (stable sort), and ``order[p]`` is the COO position of CSR edge
  ``p`` (what the JAX package's edge ids and weights follow)."""
  row = np.asarray(row)
  col = np.asarray(col)
  if num_nodes is None:
    num_nodes = int(max(row.max(initial=-1), col.max(initial=-1))) + 1
  order = np.argsort(row, kind='stable')
  return ind2ptr(row[order], num_nodes), col[order], order
