"""Graph/feature partitioning with a durable on-disk layout.

Counterpart of ``graphlearn_tpu/partition/base.py``: the pipeline (node ->
node-feature -> graph -> edge-feature partitioning) and the JAX package's
directory layout, byte for byte in the arrays (numpy ``.npy`` / ``.npz``,
META as JSON), so each package's ``load_partition`` reads the other's
directory:

  <root>/
    META.json                      {num_parts, hetero, node/edge types, ...}
    node_pb.npy | node_pb/<ntype>.npy
    edge_pb.npy | edge_pb/<etype-str>.npy
    part<i>/
      graph.npz | graph/<etype-str>.npz      rows, cols, eids[, weights]
      node_feat.npz | node_feat/<ntype>.npz  feats, ids[, cache_feats, cache_ids]
      edge_feat.npz | edge_feat/<etype-str>.npz

Partition books (node_pb/edge_pb) map global id -> owning partition; the
distributed slice reads them as its shard maps.
"""
import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..typing import (EdgeType, FeaturePartitionData, GraphPartitionData,
                      NodeType, as_str)


class PartitionerBase:
  """Drives partitioning and persistence.

  Subclasses implement `_partition_node(ntype) -> node_pb` and optionally
  `_cache_node(ntype, part) -> cached global ids`.

  Homo inputs are plain arrays; hetero inputs are dicts keyed by
  NodeType/EdgeType.
  """

  def __init__(self, output_dir: str, num_parts: int,
               num_nodes: Union[int, Dict[NodeType, int]],
               edge_index: Union[np.ndarray, Dict[EdgeType, np.ndarray]],
               node_feat=None, edge_feat=None, edge_weights=None,
               edge_assign_strategy: str = 'by_src',
               chunk_size: int = 10000):
    self.output_dir = output_dir
    self.num_parts = num_parts
    self.num_nodes = num_nodes
    self.edge_index = edge_index
    self.node_feat = node_feat
    self.edge_feat = edge_feat
    self.edge_weights = edge_weights
    self.edge_assign_strategy = edge_assign_strategy.lower()
    assert self.edge_assign_strategy in ('by_src', 'by_dst')
    self.chunk_size = chunk_size
    self.is_hetero = isinstance(edge_index, dict)

  # ------------------------------------------------------------ public API

  def partition(self):
    """Run the full pipeline and persist; returns the output directory."""
    os.makedirs(self.output_dir, exist_ok=True)
    if self.is_hetero:
      ntypes = sorted({t for et in self.edge_index for t in (et[0], et[2])})
      etypes = list(self.edge_index.keys())
      node_pbs = {}
      for nt in ntypes:
        node_pbs[nt] = self._partition_node(nt)
        self._save_node_pb(node_pbs[nt], nt)
        self._partition_and_save_node_feat(node_pbs[nt], nt)
      for et in etypes:
        edge_pb = self._partition_and_save_graph(node_pbs, et)
        self._save_edge_pb(edge_pb, et)
        self._partition_and_save_edge_feat(edge_pb, et)
      meta = dict(num_parts=self.num_parts, hetero=True,
                  node_types=ntypes,
                  edge_types=[list(et) for et in etypes])
    else:
      node_pb = self._partition_node(None)
      self._save_node_pb(node_pb, None)
      self._partition_and_save_node_feat(node_pb, None)
      edge_pb = self._partition_and_save_graph(node_pb, None)
      self._save_edge_pb(edge_pb, None)
      self._partition_and_save_edge_feat(edge_pb, None)
      meta = dict(num_parts=self.num_parts, hetero=False)
    with open(os.path.join(self.output_dir, 'META.json'), 'w') as f:
      json.dump(meta, f)
    return self.output_dir

  # ---------------------------------------------------------- partitioning

  def _partition_node(self, ntype: Optional[NodeType]) -> np.ndarray:
    raise NotImplementedError

  def _cache_node(self, ntype: Optional[NodeType],
                  part: int) -> Optional[np.ndarray]:
    """Global ids to hot-cache on `part` (FrequencyPartitioner only)."""
    return None

  def _get_edge_index(self, etype):
    ei = self.edge_index[etype] if etype is not None else self.edge_index
    ei = np.asarray(ei)
    return ei[0].reshape(-1), ei[1].reshape(-1)

  def _partition_and_save_graph(self, node_pb, etype) -> np.ndarray:
    """Assign each edge to the partition owning its src (or dst) endpoint,
    chunked to bound peak memory."""
    rows, cols = self._get_edge_index(etype)
    e = rows.shape[0]
    eids = np.arange(e, dtype=np.int64)
    if self.is_hetero:
      src_pb = node_pb[etype[0]] if self.edge_assign_strategy == 'by_src' \
          else node_pb[etype[2]]
    else:
      src_pb = node_pb
    key = rows if self.edge_assign_strategy == 'by_src' else cols
    edge_pb = np.empty(e, dtype=np.int32)
    for start in range(0, e, self.chunk_size * 64):
      end = min(e, start + self.chunk_size * 64)
      edge_pb[start:end] = src_pb[key[start:end]]
    weights = (np.asarray(self.edge_weights[etype]) if
               (self.is_hetero and isinstance(self.edge_weights, dict))
               else (np.asarray(self.edge_weights)
                     if self.edge_weights is not None and not self.is_hetero
                     else None))
    for p in range(self.num_parts):
      m = edge_pb == p
      payload = dict(rows=rows[m], cols=cols[m], eids=eids[m])
      if weights is not None:
        payload['weights'] = weights[m]
      self._save_npz(payload, f'part{p}', 'graph', etype)
    return edge_pb

  def _partition_and_save_node_feat(self, node_pb, ntype):
    feat = (self.node_feat.get(ntype) if isinstance(self.node_feat, dict)
            else (self.node_feat if ntype is None else None))
    if feat is None:
      return
    feat = np.asarray(feat)
    for p in range(self.num_parts):
      ids = np.nonzero(node_pb == p)[0].astype(np.int64)
      payload = dict(feats=feat[ids], ids=ids)
      cache_ids = self._cache_node(ntype, p)
      if cache_ids is not None and cache_ids.size:
        payload['cache_feats'] = feat[cache_ids]
        payload['cache_ids'] = cache_ids.astype(np.int64)
      self._save_npz(payload, f'part{p}', 'node_feat', ntype)

  def _partition_and_save_edge_feat(self, edge_pb, etype):
    feat = (self.edge_feat.get(etype) if isinstance(self.edge_feat, dict)
            else (self.edge_feat if etype is None else None))
    if feat is None:
      return
    feat = np.asarray(feat)
    for p in range(self.num_parts):
      ids = np.nonzero(edge_pb == p)[0].astype(np.int64)
      self._save_npz(dict(feats=feat[ids], ids=ids), f'part{p}',
                     'edge_feat', etype)

  # -------------------------------------------------------------- persist

  def _save_npz(self, payload, part_dir, name, type_=None):
    d = os.path.join(self.output_dir, part_dir)
    if type_ is not None:
      d = os.path.join(d, name)
      os.makedirs(d, exist_ok=True)
      path = os.path.join(d, f'{_type_str(type_)}.npz')
    else:
      os.makedirs(d, exist_ok=True)
      path = os.path.join(d, f'{name}.npz')
    np.savez(path, **payload)

  def _save_node_pb(self, pb, ntype):
    if ntype is None:
      np.save(os.path.join(self.output_dir, 'node_pb.npy'), pb)
    else:
      d = os.path.join(self.output_dir, 'node_pb')
      os.makedirs(d, exist_ok=True)
      np.save(os.path.join(d, f'{ntype}.npy'), pb)

  def _save_edge_pb(self, pb, etype):
    if etype is None:
      np.save(os.path.join(self.output_dir, 'edge_pb.npy'), pb)
    else:
      d = os.path.join(self.output_dir, 'edge_pb')
      os.makedirs(d, exist_ok=True)
      np.save(os.path.join(d, f'{as_str(etype)}.npy'), pb)


def _type_str(t):
  return as_str(t) if isinstance(t, (tuple, list)) else str(t)


# ---------------------------------------------------------------- loading

def _load_npz(path) -> Optional[Dict[str, np.ndarray]]:
  if not os.path.exists(path):
    return None
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def load_partition(root_dir: str, partition_idx: int):
  """Load one partition (written by either package).

  Returns (num_parts, graph_data, node_feat_data, edge_feat_data,
  node_pb, edge_pb); each is a dict for hetero layouts.
  """
  with open(os.path.join(root_dir, 'META.json')) as f:
    meta = json.load(f)
  part = os.path.join(root_dir, f'part{partition_idx}')

  def graph_from(z):
    return GraphPartitionData(
        edge_index=np.stack([z['rows'], z['cols']]), eids=z['eids'],
        weights=z.get('weights'))

  def feat_from(z):
    if z is None:
      return None
    return FeaturePartitionData(
        feats=z.get('feats'), ids=z.get('ids'),
        cache_feats=z.get('cache_feats'), cache_ids=z.get('cache_ids'))

  if meta.get('hetero'):
    graph, nfeat, efeat, node_pb, edge_pb = {}, {}, {}, {}, {}
    for et_l in meta['edge_types']:
      et = tuple(et_l)
      z = _load_npz(os.path.join(part, 'graph', f'{as_str(et)}.npz'))
      if z is not None:
        graph[et] = graph_from(z)
      f_ = feat_from(_load_npz(os.path.join(part, 'edge_feat',
                                            f'{as_str(et)}.npz')))
      if f_ is not None:
        efeat[et] = f_
      p = os.path.join(root_dir, 'edge_pb', f'{as_str(et)}.npy')
      if os.path.exists(p):
        edge_pb[et] = np.load(p)
    for nt in meta['node_types']:
      f_ = feat_from(_load_npz(os.path.join(part, 'node_feat',
                                            f'{nt}.npz')))
      if f_ is not None:
        nfeat[nt] = f_
      p = os.path.join(root_dir, 'node_pb', f'{nt}.npy')
      if os.path.exists(p):
        node_pb[nt] = np.load(p)
    return (meta['num_parts'], graph, nfeat or None, efeat or None,
            node_pb, edge_pb)

  graph = graph_from(_load_npz(os.path.join(part, 'graph.npz')))
  nfeat = feat_from(_load_npz(os.path.join(part, 'node_feat.npz')))
  efeat = feat_from(_load_npz(os.path.join(part, 'edge_feat.npz')))
  node_pb = np.load(os.path.join(root_dir, 'node_pb.npy'))
  edge_pb = np.load(os.path.join(root_dir, 'edge_pb.npy'))
  return meta['num_parts'], graph, nfeat, efeat, node_pb, edge_pb


def cat_feature_cache(part_idx: int, feat_data: FeaturePartitionData,
                      feat_pb: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Merge the hot cache into the local feature block.

  Cached rows are prepended (hot-first, matching the device-prefix layout
  of the Feature store) and the feature partition book is rewritten so cached
  ids resolve locally. Returns (feats, ids, new_feat_pb).
  """
  if feat_data.cache_feats is None or feat_data.cache_feats.size == 0:
    return feat_data.feats, feat_data.ids, feat_pb
  cache_ids = feat_data.cache_ids
  # local rows that duplicate cached rows are dropped
  local_mask = ~np.isin(feat_data.ids, cache_ids)
  feats = np.concatenate([feat_data.cache_feats,
                          feat_data.feats[local_mask]])
  ids = np.concatenate([cache_ids, feat_data.ids[local_mask]])
  new_pb = feat_pb.copy()
  new_pb[cache_ids] = part_idx
  return feats, ids, new_pb
