"""Sharded distributed graph: per-partition local CSRs stacked on a
leading shard axis.

Counterpart of ``graphlearn_tpu/distributed/dist_graph.py``. Shard p of
the leading axis is partition p's local CSR (host numpy):

  row_ids [P, R]   ascending owned global ids (INT32_MAX-padded)
  indptr  [P, R+1] local CSR offsets over the owned rows
  indices [P, E]   neighbour global ids (-1-padded)
  eids    [P, E]   global edge ids (int64, -1-padded)
  weights [P, E]   optional edge weights

``device_arrays(mesh)`` places a mesh's local shards on its device. A
row is found inside a shard by a binary search on ``row_ids``
(``ops.uniform_sample_local``); rows of other shards are reached by
routing seed ids through the exchange (``DistNeighborSampler``).
``DistHeteroGraph`` is one ``DistGraph`` per edge type (sampled by the
typed engine, ``DistNeighborSampler._hetero_engine``).
"""
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.neighbor import build_row_cumsum
from ..typing import GraphPartitionData

INT32_MAX = np.iinfo(np.int32).max


def build_local_csr(part: GraphPartitionData, by: str = 'src'):
  """A partition's edges -> ``(row_ids, indptr, indices, eids,
  weights)``, the local CSR grouped by the owned endpoint."""
  ei = np.asarray(part.edge_index)
  key = ei[0] if by == 'src' else ei[1]
  other = ei[1] if by == 'src' else ei[0]
  order = np.argsort(key, kind='stable')
  key, other = key[order], other[order]
  eids = np.asarray(part.eids)[order]
  weights = (np.asarray(part.weights)[order]
             if part.weights is not None else None)
  row_ids, counts = np.unique(key, return_counts=True)
  indptr = np.zeros(row_ids.shape[0] + 1, dtype=np.int32)
  np.cumsum(counts, out=indptr[1:])
  return row_ids.astype(np.int32), indptr, other.astype(np.int32), \
      eids, weights


def _to(mesh, arr, dtype):
  """A host array on the mesh's device (pinned and not blocking on a
  card)."""
  t = torch.as_tensor(np.ascontiguousarray(arr)).to(dtype)
  if mesh.device.type == 'cuda':
    return t.pin_memory().to(mesh.device, non_blocking=True)
  return t.to(mesh.device)


class DistGraph:
  """Stacked partitions and the partition book.

  Args:
    num_partitions / partition_idx: parity fields (partition_idx marks
      this host's first partition).
    parts: one ``GraphPartitionData`` per partition.
    node_pb: ``[N]`` global node id -> owning partition.
    edge_pb: optional ``[E_total]`` edge id -> partition.
    edge_dir: 'out' (rows by source) or 'in' (by destination).
  """

  def __init__(self, num_partitions: int, partition_idx: int,
               parts, node_pb: np.ndarray,
               edge_pb: Optional[np.ndarray] = None, edge_dir: str = 'out'):
    self.num_partitions = num_partitions
    self.partition_idx = partition_idx
    self.node_pb = np.asarray(node_pb)
    self.edge_pb = edge_pb
    self.edge_dir = edge_dir

    by = 'src' if edge_dir == 'out' else 'dst'
    locs = [build_local_csr(p, by) for p in parts]
    r_max = max(l[0].shape[0] for l in locs)
    e_max = max(l[2].shape[0] for l in locs)
    p = len(locs)
    self.row_ids = np.full((p, r_max), INT32_MAX, np.int32)
    self.indptr = np.zeros((p, r_max + 1), np.int32)
    self.indices = np.full((p, e_max), -1, np.int32)
    self.eids = np.full((p, e_max), -1, np.int64)
    has_w = locs[0][4] is not None
    self.weights = np.zeros((p, e_max), np.float32) if has_w else None
    for i, (rid, ptr, ind, eid, w) in enumerate(locs):
      r, e = rid.shape[0], ind.shape[0]
      self.row_ids[i, :r] = rid
      self.indptr[i, :r + 1] = ptr
      self.indptr[i, r + 1:] = ptr[-1]
      self.indices[i, :e] = ind
      self.eids[i, :e] = eid
      if has_w:
        self.weights[i, :e] = w

  @property
  def is_hetero(self) -> bool:
    return False

  @property
  def num_nodes(self) -> int:
    return int(self.node_pb.shape[0])

  def sorted_local_indices(self) -> np.ndarray:
    """``[P, E]`` per-shard segment-sorted neighbour ids: the membership
    table of shard-local negative sampling. Computed once."""
    if not hasattr(self, '_sorted_loc'):
      out = np.full_like(self.indices, -1)
      for p in range(self.indices.shape[0]):
        ptr, ind = self.indptr[p], self.indices[p]
        nedges = int(ptr[-1])
        rows = np.repeat(np.arange(ptr.shape[0] - 1), np.diff(ptr))
        perm = np.lexsort((ind[:nedges], rows))
        out[p, :nedges] = ind[:nedges][perm]
      self._sorted_loc = out
    return self._sorted_loc

  def row_cumsum_stacked(self) -> np.ndarray:
    """``[P, E]`` per-shard row-restarting cumulative edge weights, the
    inverse-CDF table of weighted sampling. Each shard's rows are summed
    exactly (``ops.build_row_cumsum``, as the port's single-device
    sampler does), where JAX takes one float32 running sum per shard; the
    two agree wherever that running sum is exact."""
    assert self.weights is not None, 'graph has no edge weights'
    if not hasattr(self, '_wcum'):
      out = np.zeros_like(self.weights)
      for p in range(self.weights.shape[0]):
        ptr = self.indptr[p]
        nedges = int(ptr[-1])
        out[p, :nedges] = build_row_cumsum(ptr, self.weights[p, :nedges])
      self._wcum = out
    return self._wcum

  def get_node_partitions(self, ids) -> np.ndarray:
    return self.node_pb[np.asarray(ids)]

  def get_edge_partitions(self, eids) -> Optional[np.ndarray]:
    if self.edge_pb is None:
      return None
    return self.edge_pb[np.asarray(eids)]

  def device_arrays(self, mesh):
    """The mesh's local shards on its device (``[L, ...]``) and the
    partition book (``[N]`` int32, whole on every process)."""
    loc = mesh.local_shards
    out = dict(
        row_ids=_to(mesh, self.row_ids[loc], torch.int32),
        indptr=_to(mesh, self.indptr[loc], torch.int32),
        indices=_to(mesh, self.indices[loc], torch.int32),
        eids=_to(mesh, self.eids[loc], torch.int64),
        node_pb=_to(mesh, self.node_pb, torch.int32),
    )
    if self.weights is not None:
      out['weights'] = _to(mesh, self.weights[loc], torch.float32)
    return out


class DistHeteroGraph:
  """One stacked local CSR per edge type and one partition book per node
  type.

  Args:
    num_partitions / partition_idx: as DistGraph.
    parts: a list (one per partition) of ``{EdgeType:
      GraphPartitionData}``.
    node_pb: ``{NodeType: [N_t]}`` global id -> owning partition.
    edge_pb: optional ``{EdgeType: [E_t]}``.
    edge_dir: 'out' (CSR by src) or 'in' (CSC by dst).
  """

  def __init__(self, num_partitions: int, partition_idx: int,
               parts, node_pb: Dict, edge_pb: Optional[Dict] = None,
               edge_dir: str = 'out'):
    self.num_partitions = num_partitions
    self.partition_idx = partition_idx
    self.node_pb = {t: np.asarray(pb) for t, pb in node_pb.items()}
    self.edge_pb = edge_pb
    self.edge_dir = edge_dir
    self.etypes = sorted({et for part in parts for et in part})
    self.ntypes = sorted(self.node_pb)

    empty = GraphPartitionData(edge_index=np.zeros((2, 0), np.int64),
                               eids=np.zeros((0,), np.int64))
    self.sub = {}
    for et in self.etypes:
      self.sub[et] = DistGraph(
          num_partitions, partition_idx,
          [part.get(et, empty) for part in parts],
          self.node_pb[et[0] if edge_dir == 'out' else et[2]],
          edge_dir=edge_dir)

  @property
  def is_hetero(self) -> bool:
    return True

  def num_nodes(self, ntype) -> int:
    return int(self.node_pb[ntype].shape[0])

  def device_arrays(self, mesh):
    """``{etype: local CSR arrays}`` and ``{'#pb': {ntype: book}}``."""
    out = {et: g.device_arrays(mesh) for et, g in self.sub.items()}
    out['#pb'] = {t: _to(mesh, pb, torch.int32)
                  for t, pb in self.node_pb.items()}
    return out
