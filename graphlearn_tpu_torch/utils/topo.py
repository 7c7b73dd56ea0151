"""Host-side graph layout conversions (COO/CSR/CSC).

The port's own copy of ``graphlearn_tpu/utils/topo.py`` (numpy; the same
stable edge order, so ``indices`` match the JAX package element for
element). ``coo_to_csr`` returns ``(indptr, indices, edge_ids,
edge_weights)``: without ``edge_ids`` each CSR edge's id is its COO
position, which is what the edge ids and weights of a ``Topology``
follow.
"""
from typing import Optional, Tuple

import numpy as np


def ptr2ind(indptr: np.ndarray) -> np.ndarray:
  """Expand a CSR row pointer into per-edge row ids."""
  n = indptr.shape[0] - 1
  return np.repeat(np.arange(n, dtype=indptr.dtype), np.diff(indptr))


def ind2ptr(rows: np.ndarray, num_rows: int) -> np.ndarray:
  """CSR row pointer from *sorted* per-edge row ids."""
  counts = np.bincount(rows, minlength=num_rows)
  return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def coo_to_csr(row: np.ndarray, col: np.ndarray,
               num_nodes: Optional[int] = None,
               edge_ids: Optional[np.ndarray] = None,
               edge_weights: Optional[np.ndarray] = None):
  """COO -> ``(indptr, indices, edge_ids, edge_weights)``; edges keep
  their input order within a row (stable sort). ``edge_ids`` defaults to
  each edge's COO position; ``edge_weights`` stays None without
  weights."""
  row = np.asarray(row)
  col = np.asarray(col)
  if num_nodes is None:
    num_nodes = int(max(row.max(initial=-1), col.max(initial=-1))) + 1
  if edge_ids is None:
    edge_ids = np.arange(row.shape[0], dtype=np.int64)
  order = np.argsort(row, kind='stable')
  weights = None if edge_weights is None else \
      np.asarray(edge_weights)[order]
  return (ind2ptr(row[order], num_nodes), col[order],
          np.asarray(edge_ids)[order], weights)


def coo_to_csc(row: np.ndarray, col: np.ndarray,
               num_nodes: Optional[int] = None,
               edge_ids: Optional[np.ndarray] = None,
               edge_weights: Optional[np.ndarray] = None):
  """COO -> CSC (the CSR of the transposed graph)."""
  return coo_to_csr(col, row, num_nodes, edge_ids, edge_weights)


def csr_to_coo(indptr: np.ndarray, indices: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
  return ptr2ind(indptr), indices


def csr_to_csc(indptr: np.ndarray, indices: np.ndarray,
               edge_ids: Optional[np.ndarray] = None,
               edge_weights: Optional[np.ndarray] = None):
  row, col = csr_to_coo(indptr, indices)
  return coo_to_csr(col, row, indptr.shape[0] - 1, edge_ids, edge_weights)
