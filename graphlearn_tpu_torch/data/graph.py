"""Graph topology storage: a host CSR and its device-resident copy.

Counterpart of ``graphlearn_tpu/data/graph.py``. ``Topology`` builds the
CSR (or CSC) on the host with numpy, in the same edge order as the JAX
package. ``Graph`` places ``indptr``/``indices`` on a torch device as
int32 tensors, plus the packed ``[N, 2]`` (start, degree) row table the
uniform hop reads (``csr_meta``; ``neighbor_sampler.py:_csr_meta``).
"""
from typing import Optional

import numpy as np
import torch

from ..utils import coo_to_csr, resolve_device


class Topology:
  """CSR-or-CSC adjacency on the host.

  Args:
    edge_index: ``[2, E]`` COO (row, col).
    layout: storage layout, 'CSR' (grouped by src) or 'CSC' (by dst).
    num_nodes: optional node count.
  """

  def __init__(self, edge_index, layout: str = 'CSR',
               num_nodes: Optional[int] = None):
    if layout not in ('CSR', 'CSC'):
      raise ValueError(f'storage layout must be CSR or CSC, got {layout!r}')
    row = np.asarray(edge_index[0]).reshape(-1)
    col = np.asarray(edge_index[1]).reshape(-1)
    if num_nodes is None:
      num_nodes = int(max(row.max(initial=-1), col.max(initial=-1))) + 1
    key, other = (row, col) if layout == 'CSR' else (col, row)
    indptr, indices = coo_to_csr(key, other, num_nodes)
    self.layout = layout
    self.indptr = indptr
    self.indices = indices.astype(np.int32)
    self.num_nodes = num_nodes

  @property
  def num_edges(self) -> int:
    return int(self.indices.shape[0])


class Graph:
  """Device-placed CSR (``graphlearn_tpu/data/graph.py:Graph``).

  ``device=None`` means the card. The arrays are int32, as in the JAX
  package: a single graph holds fewer than 2**31 edges.
  """

  def __init__(self, topo: Topology, device=None):
    if topo.num_edges >= 2 ** 31:
      raise ValueError('int32 CSR: shard graphs of 2**31 edges or more')
    self.topo = topo
    self.device = resolve_device(device)
    self.indptr = torch.as_tensor(topo.indptr.astype(np.int32)).to(
        self.device)
    self.indices = torch.as_tensor(topo.indices).to(self.device)
    self._csr_meta = None

  @property
  def csr_meta(self) -> torch.Tensor:
    """Packed ``[N, 2]`` int32 (start, degree) table: one row read per
    seed instead of two indptr reads."""
    if self._csr_meta is None:
      ptr = self.indptr
      self._csr_meta = torch.stack([ptr[:-1], ptr[1:] - ptr[:-1]], dim=1)
    return self._csr_meta

  @property
  def num_nodes(self) -> int:
    return self.topo.num_nodes

  @property
  def num_edges(self) -> int:
    return self.topo.num_edges
