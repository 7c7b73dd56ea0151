"""Distributed dataset: the partitioned graph, features and books on the
mesh.

Counterpart of ``graphlearn_tpu/distributed/dist_dataset.py``, for the
homogeneous layout that ``partition.RandomPartitioner`` /
``FrequencyPartitioner`` write. ``load()`` reads every partition of a
directory and stacks them into ``DistGraph`` / ``DistFeature``; a
partition's feature cache is merged by ``cat_feature_cache``. The typed
layout and the disk-tiered feature store (``feature_spill_dir``) come
with later slices.
"""
from typing import Optional

import numpy as np

from ..partition import cat_feature_cache, load_partition
from .dist_feature import DistFeature
from .dist_graph import DistGraph


class DistDataset:
  """A ``DistGraph``, its node (and edge) ``DistFeature`` and labels."""

  def __init__(self, num_partitions: int = 1, partition_idx: int = 0,
               dist_graph: Optional[DistGraph] = None,
               dist_feature: Optional[DistFeature] = None,
               node_labels=None, node_feat_pb=None, edge_dir: str = 'out',
               edge_features: Optional[DistFeature] = None):
    self.num_partitions = num_partitions
    self.partition_idx = partition_idx
    self.graph = dist_graph
    self.node_features = dist_feature
    self.edge_features = edge_features
    self.node_labels = node_labels
    self.node_feat_pb = node_feat_pb
    self.edge_dir = edge_dir

  def load(self, root_dir: str, mesh=None, node_labels=None,
           edge_dir: str = 'out', feature_dtype=None,
           feature_with_cache: bool = True, split_ratio: float = 0.0,
           cache_rows=None, hotness='in_degree', wire_dtype=None,
           bucket_frac=2.0, feature_spill_dir=None):
    """Load every partition of ``root_dir`` onto ``mesh`` (default: the
    context's).

    ``split_ratio`` / ``cache_rows`` cache that share (or count) of the
    globally hottest feature rows on every shard, ranked by ``hotness``:
    'in_degree' (edge destinations counted over the loaded partitions),
    explicit ``[N]`` scores, or None (the lowest ids). ``wire_dtype`` /
    ``bucket_frac`` tune the miss exchange (``DistFeature``)."""
    if feature_spill_dir is not None:
      raise NotImplementedError(
          'feature_spill_dir (the disk-tiered distributed store) comes '
          'with the distributed scanned store, a later slice')
    num_parts, g0, nf0, ef0, node_pb, edge_pb = load_partition(root_dir, 0)
    if isinstance(g0, dict):
      raise NotImplementedError(
          'the typed partition layout (DistHeteroGraph datasets) comes '
          'with the next distributed slice')
    if mesh is None:
      from .dist_context import get_context
      ctx = get_context()
      mesh = ctx.mesh if ctx else None
    parts, nfeats, efeats = [g0], [nf0], [ef0]
    for p in range(1, num_parts):
      _, g, nf, ef, _, _ = load_partition(root_dir, p)
      parts.append(g)
      nfeats.append(nf)
      efeats.append(ef)
    self.num_partitions = num_parts
    self.edge_dir = edge_dir
    with_cache = split_ratio > 0 or cache_rows is not None

    def _hotness(num_nodes):
      if not with_cache:
        return None
      if isinstance(hotness, str):
        assert hotness == 'in_degree', hotness
        deg = np.zeros((num_nodes,), np.int64)
        for g in parts:
          np.add.at(deg, np.clip(g.edge_index[1], 0, num_nodes - 1), 1)
        return deg
      return hotness

    feat_kw = dict(mesh=mesh, dtype=feature_dtype, wire_dtype=wire_dtype,
                   bucket_frac=bucket_frac)
    self.graph = DistGraph(num_parts, 0, parts, node_pb, edge_pb, edge_dir)
    if nf0 is not None:
      feat_pb = node_pb.astype(np.int32).copy()
      blocks = []
      for p, nf in enumerate(nfeats):
        if feature_with_cache and nf.cache_feats is not None:
          feats, ids, feat_pb = cat_feature_cache(p, nf, feat_pb)
        else:
          feats, ids = nf.feats, nf.ids
        blocks.append((ids, feats))
      self.node_feat_pb = feat_pb
      # lookups route by the graph's node_pb (each id's canonical
      # owner); the feature book with cache entries is kept for host-side
      # locality decisions
      self.node_features = DistFeature(
          num_parts, blocks, node_pb, hotness=_hotness(node_pb.shape[0]),
          split_ratio=split_ratio, cache_rows=cache_rows, **feat_kw)
    if ef0 is not None:
      self.edge_features = DistFeature(
          num_parts, [(ef.ids, ef.feats) for ef in efeats], edge_pb,
          **feat_kw)
    if node_labels is not None:
      self.node_labels = np.asarray(node_labels)
    return self

  def feature_stores(self):
    """Every ``DistFeature`` this dataset owns (node and edge)."""
    for store in (self.node_features, self.edge_features):
      if store is not None:
        yield store

  @property
  def node_pb(self):
    return self.graph.node_pb if self.graph is not None else None
