"""Dataset: graph(s) + node and edge features + labels, homogeneous or
heterogeneous.

Counterpart of ``graphlearn_tpu/data/dataset.py:Dataset``. ``edge_dir``
picks CSR (out-edges) or CSC (in-edges) storage. Node features may be
hotness-reordered (``sort_func``, e.g. ``sort_by_in_degree``) and split
between the device and the host (``split_ratio``), with the ``id2index``
map threaded into the ``Feature`` store. The dataset's ``device`` (None
means the card) is every part's device unless a call names another.
Edge features are keyed by edge id (the graph's ``edge_ids``: the input
position unless given). A heterogeneous dataset holds dicts: graphs and
edge features keyed by ``EdgeType``, features, labels and node counts by
``NodeType``, one ``Feature`` (with its own hot/cold split) per type.
"""
from typing import Optional

import numpy as np
import torch

from ..typing import EdgeType, NodeType
from ..utils import resolve_device
from .feature import Feature
from .graph import Graph, Topology


class Dataset:
  """Graph, node and edge features and labels."""

  def __init__(self, graph=None, node_features=None, edge_features=None,
               node_labels=None, edge_dir: str = 'out', device=None):
    self.device = resolve_device(device)
    self.graph = graph
    self.node_features = node_features
    self.edge_features = edge_features
    self.node_labels = node_labels
    self.edge_dir = edge_dir

  def _device(self, device):
    return self.device if device is None else resolve_device(device)

  def init_graph(self, edge_index=None, edge_ids=None, edge_weights=None,
                 layout='COO', graph_mode='HBM', device=None,
                 num_nodes=None):
    """Build the Graph from ``edge_index`` in ``layout`` ('COO' ``[2, E]``,
    or 'CSR' / 'CSC' ``(indptr, indices)``), with optional ``[E]`` edge
    ids (default: the input position) and weights (weighted sampling).
    ``graph_mode`` as ``Graph``'s; ``device`` defaults to the dataset's."""
    if edge_index is None:
      return self
    store_layout = 'CSR' if self.edge_dir == 'out' else 'CSC'
    dev = self._device(device)

    def build(ei, eids, ew, n):
      topo = Topology(ei, eids, ew, input_layout=layout, layout=store_layout,
                      num_nodes=n)
      return Graph(topo, graph_mode, dev)

    if isinstance(edge_index, dict):
      self.graph = {}
      for etype, ei in edge_index.items():
        eids = edge_ids.get(etype) if isinstance(edge_ids, dict) else None
        ew = (edge_weights.get(etype)
              if isinstance(edge_weights, dict) else None)
        n = num_nodes.get(etype) if isinstance(num_nodes, dict) else num_nodes
        self.graph[etype] = build(ei, eids, ew, n)
    else:
      self.graph = build(edge_index, edge_ids, edge_weights, num_nodes)
    return self

  def init_node_features(self, node_feature_data=None, id2idx=None,
                         sort_func=None, split_ratio: float = 1.0,
                         device_group_list=None, device=None,
                         with_device: bool = True, dtype=None):
    """The node ``Feature`` store. With ``sort_func`` (e.g.
    ``sort_by_in_degree``) and no ``id2idx``, rows are hotness-reordered
    by the graph's topology and the produced map installed. The first
    ``int(N * split_ratio)`` rows live on the device (default: all, as in
    the JAX package), the rest in host memory."""
    if node_feature_data is None:
      return self
    dev = self._device(device)

    def build(feat, topo, i2i):
      feat = np.asarray(feat)
      if sort_func is not None and i2i is None and topo is not None:
        feat, i2i = sort_func(feat, split_ratio, topo)
      return Feature(feat, split_ratio, device_group_list, dev, with_device,
                     i2i, dtype)

    if isinstance(node_feature_data, dict):
      self.node_features = {}
      for ntype, feat in node_feature_data.items():
        i2i = id2idx.get(ntype) if isinstance(id2idx, dict) else None
        self.node_features[ntype] = build(
            feat, self._topo_for_node_type(ntype), i2i)
    else:
      topo = self.graph.topo if isinstance(self.graph, Graph) else None
      self.node_features = build(node_feature_data, topo, id2idx)
    return self

  def init_edge_features(self, edge_feature_data=None, split_ratio=1.0,
                         device_group_list=None, device=None,
                         with_device: bool = True, dtype=None):
    """The ``[E, F_e]`` edge-feature store, rows keyed by edge id (no
    hotness reorder)."""
    if edge_feature_data is None:
      return self
    dev = self._device(device)

    def build(f):
      return Feature(np.asarray(f), split_ratio, device_group_list, dev,
                     with_device, None, dtype)

    if isinstance(edge_feature_data, dict):
      self.edge_features = {etype: build(f)
                            for etype, f in edge_feature_data.items()}
    else:
      self.edge_features = build(edge_feature_data)
    return self

  def init_node_labels(self, node_label_data=None):
    def build(y):
      return torch.as_tensor(np.asarray(y)).to(self.device)

    if node_label_data is not None:
      if isinstance(node_label_data, dict):
        self.node_labels = {k: build(v) for k, v in node_label_data.items()}
      else:
        self.node_labels = build(node_label_data)
    return self

  def get_graph(self, etype: Optional[EdgeType] = None):
    if isinstance(self.graph, dict):
      return self.graph.get(etype) if etype is not None else None
    return self.graph

  def get_node_feature(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_features, dict):
      return self.node_features.get(ntype) if ntype is not None else None
    return self.node_features

  def get_edge_feature(self, etype: Optional[EdgeType] = None):
    if isinstance(self.edge_features, dict):
      return self.edge_features.get(etype) if etype is not None else None
    return self.edge_features

  def get_node_label(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_labels, dict):
      return self.node_labels.get(ntype) if ntype is not None else None
    return self.node_labels

  def get_node_types(self):
    if isinstance(self.graph, dict):
      ntypes = []
      for (src, _, dst) in self.graph.keys():
        for t in (src, dst):
          if t not in ntypes:
            ntypes.append(t)
      return ntypes
    return None

  def get_edge_types(self):
    if isinstance(self.graph, dict):
      return list(self.graph.keys())
    return None

  @property
  def is_hetero(self) -> bool:
    return isinstance(self.graph, dict)

  def _topo_for_node_type(self, ntype: NodeType):
    """The topology whose key axis is this node type, for in-degree
    hotness: the CSR of an edge type with src ``ntype`` under
    ``edge_dir='out'``, the CSC of one with dst ``ntype`` under 'in'."""
    if not isinstance(self.graph, dict):
      return None
    for (src, _, dst), g in self.graph.items():
      key_type = src if self.edge_dir == 'out' else dst
      if key_type == ntype:
        return g.topo
    return None

  def share_ipc(self):
    """The dataset itself, as in the JAX package: sent through
    ``torch.multiprocessing``, its device tensors travel as CUDA IPC
    handles and each ``Feature`` as its own IPC handle (its host tail in
    shared memory, mapped again by the receiver)."""
    return self
