"""Graph topology storage: a host CSR and its device-resident copy.

Counterpart of ``graphlearn_tpu/data/graph.py``. ``Topology`` builds the
CSR (or CSC) on the host with numpy from COO, CSR or CSC input, in the
same edge order as the JAX package. ``Graph`` places ``indptr`` /
``indices`` on a torch device as int32 tensors, plus the packed
``[N, 2]`` (start, degree) row table the uniform hop reads
(``csr_meta``; ``neighbor_sampler.py:_csr_meta``) and, at first use, the
int64 edge ids (``with_edge`` sampling).

Modes, mapped as the JAX package maps them: ``'HBM'``, ``'CUDA'``,
``'DMA'``, ``'DEVICE'`` and ``'ZERO_COPY'`` put the CSR on the device;
``'CPU'`` keeps it in host memory, and a sampler on another device
copies it there when it is built (:meth:`Graph.on`), as jax moves a numpy
argument to the device it runs on.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import coo_to_csr, ptr2ind, resolve_device

Layout = str  # 'COO' | 'CSR' | 'CSC'

_DEVICE_MODES = ('HBM', 'CUDA', 'DMA', 'DEVICE', 'ZERO_COPY')


class Topology:
  """CSR-or-CSC adjacency on the host.

  Args:
    edge_index: ``[2, E]`` COO (row, col), or ``(indptr, indices)`` when
      ``input_layout`` is 'CSR' or 'CSC'.
    edge_ids: optional ``[E]`` global edge ids in input order (default:
      the input position), kept as int64 in the storage's edge order: the
      stable sort by key of ``graphlearn_tpu/utils/topo.py:43-45``, so
      edges with equal keys keep their input order.
    edge_weights: optional ``[E]`` float weights in input order, kept on
      the host in the storage's edge order (weighted sampling builds its
      row CDF from them).
    input_layout: layout of ``edge_index``: 'COO', 'CSR' or 'CSC'.
    layout: storage layout, 'CSR' (grouped by src) or 'CSC' (by dst).
    num_nodes: optional node count.
  """

  def __init__(self, edge_index, edge_ids=None, edge_weights=None,
               input_layout: str = 'COO', layout: str = 'CSR',
               num_nodes: Optional[int] = None):
    if layout not in ('CSR', 'CSC'):
      raise ValueError(f'storage layout must be CSR or CSC, got {layout!r}')
    input_layout = input_layout.upper()
    if input_layout == 'COO':
      row = np.asarray(edge_index[0]).reshape(-1)
      col = np.asarray(edge_index[1]).reshape(-1)
    elif input_layout in ('CSR', 'CSC'):
      src = ptr2ind(np.asarray(edge_index[0]).reshape(-1))
      ind = np.asarray(edge_index[1]).reshape(-1)
      row, col = (src, ind) if input_layout == 'CSR' else (ind, src)
    else:
      raise ValueError(f'unknown input layout {input_layout!r}')
    if num_nodes is None:
      num_nodes = int(max(row.max(initial=-1), col.max(initial=-1))) + 1
    key, other = (row, col) if layout == 'CSR' else (col, row)
    indptr, indices, order, _ = coo_to_csr(key, other, num_nodes)

    def per_edge(vals, what):
      vals = np.asarray(vals).reshape(-1)
      if vals.shape[0] != row.shape[0]:
        raise ValueError(f'{vals.shape[0]} {what} for {row.shape[0]} '
                         'edges')
      return vals[order]

    self.edge_weights = (None if edge_weights is None
                         else per_edge(edge_weights, 'edge weights'))
    self.edge_ids = (order.astype(np.int64) if edge_ids is None
                     else per_edge(edge_ids, 'edge ids').astype(np.int64))
    self.layout = layout
    self.indptr = indptr
    self.indices = indices.astype(np.int32)
    self._num_nodes = num_nodes

  @property
  def num_nodes(self) -> int:
    return self._num_nodes

  @property
  def num_edges(self) -> int:
    return int(self.indices.shape[0])

  @property
  def degrees(self) -> np.ndarray:
    return np.diff(self.indptr)

  def degree(self, ids) -> np.ndarray:
    ids = np.asarray(ids)
    return self.indptr[ids + 1] - self.indptr[ids]

  @property
  def max_degree(self) -> int:
    d = self.degrees
    return int(d.max()) if d.size else 0

  def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
    """``(row, col)`` whatever the storage layout."""
    key = ptr2ind(self.indptr)
    if self.layout == 'CSR':
      return key, self.indices
    return self.indices, key

  def to_csc(self):
    """``(indptr, indices, edge_ids, edge_weights)`` of the transposed
    grouping."""
    key = ptr2ind(self.indptr)
    indptr, indices, order, _ = coo_to_csr(self.indices, key,
                                        self.indptr.shape[0] - 1)
    weights = (None if self.edge_weights is None
               else self.edge_weights[order])
    return indptr, indices, self.edge_ids[order], weights


class Graph:
  """The CSR on a device (``graphlearn_tpu/data/graph.py:Graph``).

  ``mode``: 'HBM' (and its aliases 'CUDA', 'DMA', 'DEVICE',
  'ZERO_COPY') places the arrays on ``device`` (None means the card);
  'CPU' keeps them in host memory. The arrays are int32, as in the JAX
  package: a single graph holds fewer than 2**31 edges.
  """

  def __init__(self, topo: Topology, mode: str = 'HBM', device=None,
               id_dtype=np.int32):
    if topo.num_edges >= 2 ** 31:
      raise ValueError('int32 CSR: shard graphs of 2**31 edges or more')
    if np.dtype(id_dtype) != np.int32:
      raise ValueError('the port keeps node ids as int32 (its kernels '
                       f'read int32 CSRs), got id_dtype={id_dtype!r}')
    mode = mode.upper()
    if mode in _DEVICE_MODES:
      mode = 'HBM'
    if mode not in ('CPU', 'HBM'):
      raise ValueError(f'unknown graph mode {mode!r}')
    self.topo = topo
    self.mode = mode
    self.id_dtype = id_dtype
    self.device = (torch.device('cpu') if mode == 'CPU'
                   else resolve_device(device))
    self.indptr = torch.as_tensor(topo.indptr.astype(np.int32)).to(
        self.device)
    self.indices = torch.as_tensor(topo.indices).to(self.device)
    self._csr_meta = None
    self._edge_ids = None

  def on(self, device) -> 'Graph':
    """This graph with its arrays on ``device``: itself when they are
    there, else a device ('HBM') copy over the same topology."""
    device = torch.device(device)
    if _same_device(self.device, device):
      return self
    return Graph(self.topo, 'HBM', device)

  @property
  def csr_meta(self) -> torch.Tensor:
    """Packed ``[N, 2]`` int32 (start, degree) table: one row read per
    seed instead of two indptr reads."""
    if self._csr_meta is None:
      ptr = self.indptr
      self._csr_meta = torch.stack([ptr[:-1], ptr[1:] - ptr[:-1]], dim=1)
    return self._csr_meta

  @property
  def edge_ids(self):
    """``[E]`` int64 edge ids in CSR order on the graph's device (uploaded
    at first use), or None for a topology without them."""
    if self._edge_ids is None and self.topo.edge_ids is not None:
      self._edge_ids = torch.as_tensor(self.topo.edge_ids).to(self.device)
    return self._edge_ids

  @property
  def num_nodes(self) -> int:
    return self.topo.num_nodes

  @property
  def edge_weights(self):
    """The host ``[E]`` edge weights in CSR order, or None."""
    return self.topo.edge_weights

  @property
  def num_edges(self) -> int:
    return self.topo.num_edges

  @property
  def layout(self) -> str:
    return self.topo.layout

  def degree(self, ids) -> np.ndarray:
    """Host-side degree lookup."""
    return self.topo.degree(np.asarray(ids))

  def share_ipc(self):
    """``(topo, mode)``: the host topology another consumer rebuilds the
    device arrays from (``Graph(*handle)``), as in the JAX package."""
    return self.topo, self.mode


def _same_device(a: torch.device, b: torch.device) -> bool:
  """Equal devices, ``cuda`` and ``cuda:<current>`` alike."""
  if a.type != b.type:
    return False
  if a.type != 'cuda':
    return True
  cur = torch.cuda.current_device()
  return (a.index if a.index is not None else cur) == \
      (b.index if b.index is not None else cur)
