"""Distributed tabular ingestion: sliced table reads -> parallel
partition -> a mesh-sharded ``DistDataset``.

Counterpart of ``graphlearn_tpu/distributed/dist_table_dataset.py``: the
table sources are local columnar files (.npy / .npz / .csv, as
``data/table_dataset.py``'s; ``odps://`` URLs need ``common_io``), each
rank reads its strided slice, :class:`DistRandomPartitioner` exchanges
chunks through the shared filesystem, and the merged layout loads into
the port's ``DistGraph`` / ``DistFeature``.
"""
import os
import tempfile
from typing import Dict, Optional, Union

import numpy as np

from .dist_dataset import DistDataset
from .dist_random_partitioner import DistRandomPartitioner


def _read_edge_table(path: str, rank: int, world_size: int):
  """[2, E] (or [E, 2/3]) id pairs; rank reads rows [rank::world_size]
  (the slice_id / slice_count contract). An optional third
  column carries global edge ids."""
  from ..data.table_dataset import _load_table
  if str(path).startswith('odps://'):
    raise ImportError('ODPS tables require the common_io package; use '
                      'local tables instead')
  raw = _load_table(path)
  if isinstance(raw, dict):          # .npz: rows/cols(+eids) arrays
    try:
      cols_ = [raw['rows'], raw['cols']]
    except KeyError as e:
      raise ValueError(
          f'edge table {path!r}: .npz must carry "rows" and "cols" '
          f'(optional "eids"); found {sorted(raw)}') from e
    if 'eids' in raw:
      cols_.append(raw['eids'])
    arr = np.stack([np.asarray(c).reshape(-1) for c in cols_], axis=1)
  else:
    arr = np.asarray(raw)
    if arr.ndim != 2:
      raise ValueError(f'edge table {path!r} must be 2-D id pairs, got '
                       f'shape {arr.shape}')
    if arr.shape[0] in (2, 3) and arr.shape[1] > 3:
      arr = arr.T                    # [2/3, E] -> [E, 2/3]
  total = arr.shape[0]
  arr = arr[rank::world_size]
  rows = arr[:, 0].astype(np.int64)
  cols = arr[:, 1].astype(np.int64)
  # without an explicit eid column, global table row positions serve as
  # edge ids — they stay globally unique across rank slices (each rank
  # defaulting to a local arange would collide)
  eids = (arr[:, 2].astype(np.int64) if arr.shape[1] > 2
          else np.arange(total, dtype=np.int64)[rank::world_size])
  return rows, cols, eids


def _read_node_table(path: str, rank: int, world_size: int):
  """.npz with 'ids' + 'feats' (+optional 'labels'); strided slice."""
  from ..data.table_dataset import _load_table
  z = _load_table(path)
  if not isinstance(z, dict):
    raise ValueError(f'node table {path!r} must be an .npz with '
                     "'ids' and 'feats'")
  ids = np.asarray(z['ids'])[rank::world_size].astype(np.int64)
  feats = np.asarray(z['feats'])[rank::world_size]
  labels = (np.asarray(z['labels'])[rank::world_size]
            if 'labels' in z else None)
  return ids, feats, labels


class DistTableDataset(DistDataset):
  """A ``DistDataset`` read from tables by cooperating ranks."""

  def load_tables(self, edge_tables: Union[str, Dict],
                  node_tables: Union[str, Dict],
                  num_nodes: Union[int, Dict],
                  num_partitions: int = 1, partition_idx: int = 0,
                  world_size: Optional[int] = None,
                  output_dir: Optional[str] = None, mesh=None,
                  edge_assign_strategy: str = 'by_src',
                  master_addr: str = '127.0.0.1',
                  master_port: Optional[int] = None,
                  edge_dir: str = 'out', feature_dtype=None,
                  seed: int = 0):
    """Read this rank's slice of the tables, co-partition with the other
    ranks, and load the result as a mesh-sharded DistDataset.

    Args:
      edge_tables: path (homo) or {edge_type: path} (hetero).
      node_tables: path or {node_type: path}; .npz with ids/feats
        (+labels).
      num_nodes: global node count (dict per ntype for hetero).
      num_partitions / partition_idx: partition grid; partition_idx is
        also this rank's slice id.
      world_size: number of cooperating loader ranks (defaults to
        num_partitions).
      output_dir: shared filesystem staging dir (temp dir if omitted —
        single-host only).
    """
    ws = world_size or num_partitions
    hetero = isinstance(edge_tables, dict)
    if output_dir is None and ws > 1:
      raise ValueError(
          'multi-rank load_tables needs a SHARED output_dir (the ranks '
          'exchange partition chunks through it); the per-process temp '
          'default would silo each rank')
    out = output_dir or os.path.join(tempfile.gettempdir(),
                                     f'glt_table_{os.getpid()}')
    os.makedirs(out, exist_ok=True)

    if hetero:
      edge_index, edge_ids = {}, {}
      for et, path in edge_tables.items():
        r, c, e = _read_edge_table(path, partition_idx, ws)
        edge_index[et] = np.stack([r, c])
        if e is not None:
          edge_ids[et] = e
      node_feat, node_feat_ids, labels = {}, {}, {}
      for nt, path in node_tables.items():
        ids, feats, lab = _read_node_table(path, partition_idx, ws)
        node_feat[nt], node_feat_ids[nt] = feats, ids
        if lab is not None:
          labels[nt] = (ids, lab)
      edge_ids = edge_ids or None
    else:
      r, c, e = _read_edge_table(edge_tables, partition_idx, ws)
      edge_index, edge_ids = np.stack([r, c]), e
      ids, feats, lab = _read_node_table(node_tables, partition_idx, ws)
      node_feat, node_feat_ids = feats, ids
      labels = (ids, lab) if lab is not None else None

    DistRandomPartitioner(
        out, num_nodes, edge_index, edge_ids, node_feat, node_feat_ids,
        num_parts=num_partitions, rank=partition_idx, world_size=ws,
        master_addr=master_addr, master_port=master_port, seed=seed,
        edge_assign_strategy=edge_assign_strategy).partition()

    self.load(out, mesh=mesh, edge_dir=edge_dir,
              feature_dtype=feature_dtype)
    self.node_labels = self._assemble_labels(labels, num_nodes, hetero)
    return self

  def _assemble_labels(self, labels, num_nodes, hetero):
    """Scatter this rank's sliced (ids, labels) into a full [N] array.
    Each rank's loader holds the full array with only its slice filled —
    collate gathers labels by id, and training seeds come from this
    rank's slice."""
    if labels is None or (hetero and not labels):
      return None
    if hetero:
      out = {}
      for nt, (ids, lab) in labels.items():
        full = np.zeros((num_nodes[nt],) + lab.shape[1:], lab.dtype)
        full[ids] = lab
        out[nt] = full
      return out
    ids, lab = labels
    full = np.zeros((num_nodes,) + lab.shape[1:], lab.dtype)
    full[ids] = lab
    return full
