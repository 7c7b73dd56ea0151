"""Distributed dataset: the partitioned graph, features and books on the
mesh.

Counterpart of ``graphlearn_tpu/distributed/dist_dataset.py``, for the
homogeneous and the typed layouts that ``partition.RandomPartitioner`` /
``FrequencyPartitioner`` write. ``load()`` reads every partition of a
directory and stacks them into ``DistGraph`` / ``DistFeature`` (typed:
``DistHeteroGraph`` and a ``{ntype: DistFeature}`` / ``{etype:
DistFeature}`` dict, each type's hot cache ranked by its own hotness); a
partition's feature cache is merged by ``cat_feature_cache``.
``feature_spill_dir`` builds the node feature stores as
``storage.TieredDistFeature`` over disk tiers under that directory.
"""
import os
from typing import Optional

import numpy as np

from ..partition import cat_feature_cache, load_partition
from .dist_feature import DistFeature
from .dist_graph import DistGraph, DistHeteroGraph


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
    context's), homogeneous or typed.

    ``split_ratio`` / ``cache_rows`` cache that share (or count) of the
    globally hottest feature rows on every shard, ranked by ``hotness``:
    'in_degree' (edge destinations counted over the loaded partitions,
    per node type on a typed graph), explicit ``[N]`` scores (a ``{ntype:
    scores}`` dict on a typed graph), or None (the lowest ids).
    ``wire_dtype`` / ``bucket_frac`` tune the miss exchange
    (``DistFeature``). ``feature_spill_dir`` builds the node feature
    stores as ``storage.TieredDistFeature``: the partitions' rows spill to
    disk tiers under that directory (``node`` / ``node_<ntype>``)."""
    num_parts, g0, nf0, ef0, node_pb, edge_pb = load_partition(root_dir, 0)
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

    def _in_degree(num_nodes, ntype=None):
      deg = np.zeros((num_nodes,), np.int64)
      for g in parts:
        ets = ([et for et in g if et[2] == ntype] if isinstance(g, dict)
               else [None])
        for et in ets:
          cols = (g[et] if et is not None else g).edge_index[1]
          np.add.at(deg, np.clip(cols, 0, num_nodes - 1), 1)
      return deg

    def _hotness(num_nodes, ntype=None):
      if not with_cache:
        return None
      if isinstance(hotness, str):
        assert hotness == 'in_degree', hotness
        return _in_degree(num_nodes, ntype)
      if isinstance(hotness, dict):
        return hotness.get(ntype) if hotness else None
      return hotness

    feat_kw = dict(mesh=mesh, dtype=feature_dtype, wire_dtype=wire_dtype,
                   bucket_frac=bucket_frac)
    cache_kw = dict(split_ratio=split_ratio, cache_rows=cache_rows)

    def _node_store_cls(subdir):
      """The node store's class and extra arguments: a ``DistFeature``,
      or the disk-backed ``TieredDistFeature`` under a spill dir."""
      if feature_spill_dir is None:
        return DistFeature, {}
      from ..storage.dist import TieredDistFeature
      return TieredDistFeature, {
          'spill_dir': os.path.join(feature_spill_dir, subdir)}

    def _blocks(nfs, feat_pb):
      blocks = []
      for p, nf in enumerate(nfs):
        if feature_with_cache and nf.cache_feats is not None:
          feats, ids, feat_pb = cat_feature_cache(p, nf, feat_pb)
        else:
          feats, ids = nf.feats, nf.ids
        blocks.append((ids, feats))
      return blocks, feat_pb

    if isinstance(g0, dict):
      self.graph = DistHeteroGraph(num_parts, 0, parts, node_pb,
                                   edge_pb or None, edge_dir)
      if nf0:
        self.node_features, self.node_feat_pb = {}, {}
        for nt in nf0:
          blocks, self.node_feat_pb[nt] = _blocks(
              [nf[nt] for nf in nfeats], node_pb[nt].astype(np.int32).copy())
          cls, extra = _node_store_cls(f'node_{nt}')
          self.node_features[nt] = cls(
              num_parts, blocks, node_pb[nt],
              hotness=_hotness(node_pb[nt].shape[0], nt), **cache_kw,
              **feat_kw, **extra)
      if ef0:
        self.edge_features = {
            et: DistFeature(num_parts,
                            [(ef[et].ids, ef[et].feats) for ef in efeats],
                            edge_pb[et], **feat_kw)
            for et in ef0}
    else:
      self.graph = DistGraph(num_parts, 0, parts, node_pb, edge_pb,
                             edge_dir)
      if nf0 is not None:
        blocks, self.node_feat_pb = _blocks(
            nfeats, node_pb.astype(np.int32).copy())
        # lookups route by the graph's node_pb (each id's canonical
        # owner); the feature book with cache entries is kept for
        # host-side locality decisions
        cls, extra = _node_store_cls('node')
        self.node_features = cls(
            num_parts, blocks, node_pb, hotness=_hotness(node_pb.shape[0]),
            **cache_kw, **feat_kw, **extra)
      if ef0 is not None:
        self.edge_features = DistFeature(
            num_parts, [(ef.ids, ef.feats) for ef in efeats], edge_pb,
            **feat_kw)
    if node_labels is not None:
      self.node_labels = (node_labels if isinstance(node_labels, dict)
                          else np.asarray(node_labels))
    return self

  def feature_stores(self):
    """Every ``DistFeature`` this dataset owns (node and edge, over the
    per-type dicts of a typed dataset)."""
    for store in (self.node_features, self.edge_features):
      if store is not None:
        yield from (store.values() if isinstance(store, dict) else [store])

  @property
  def node_pb(self):
    return self.graph.node_pb if self.graph is not None else None
