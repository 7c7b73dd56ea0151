"""Dataset: graph + node and edge features + labels, homogeneous.

Counterpart of ``graphlearn_tpu/data/dataset.py:Dataset``. ``edge_dir``
picks CSR (out-edges) or CSC (in-edges) storage; every tensor lives on
the dataset's device (None means the card). Edge features are keyed by
edge id (the graph's ``edge_ids``: the COO position unless given).
"""
import numpy as np
import torch

from ..utils import resolve_device
from .feature import Feature
from .graph import Graph, Topology


class Dataset:
  """Graph, node and edge features and labels on one device."""

  def __init__(self, graph=None, node_features=None, node_labels=None,
               edge_dir: str = 'out', device=None, edge_features=None):
    self.device = resolve_device(device)
    self.graph = graph
    self.node_features = node_features
    self.edge_features = edge_features
    self.node_labels = node_labels
    self.edge_dir = edge_dir

  def init_graph(self, edge_index=None, num_nodes=None, edge_weights=None,
                 edge_ids=None):
    """Build the device Graph from ``[2, E]`` COO (and optional ``[E]``
    edge weights, for weighted sampling, and ``[E]`` edge ids, default
    the COO position)."""
    if edge_index is None:
      return self
    if isinstance(edge_index, dict):
      raise NotImplementedError('heterogeneous graphs come in a later '
                                'slice of the port')
    topo = Topology(edge_index,
                    layout='CSR' if self.edge_dir == 'out' else 'CSC',
                    num_nodes=num_nodes, edge_weights=edge_weights,
                    edge_ids=edge_ids)
    self.graph = Graph(topo, self.device)
    return self

  def init_node_features(self, node_feature_data=None, id2idx=None,
                         split_ratio: float = 1.0, dtype=None):
    if node_feature_data is None:
      return self
    if isinstance(node_feature_data, dict):
      raise NotImplementedError('heterogeneous features come in a later '
                                'slice of the port')
    if split_ratio != 1.0:
      raise NotImplementedError(
          'only the all-device feature table (split_ratio=1.0) is ported; '
          'the host/cold split comes with the UVA slice')
    self.node_features = Feature(node_feature_data, self.device, id2idx,
                                 dtype)
    return self

  def init_edge_features(self, edge_feature_data=None,
                         split_ratio: float = 1.0, dtype=None):
    """The ``[E, F_e]`` edge-feature table, rows keyed by edge id, all on
    the device (``graphlearn_tpu/data/dataset.py:init_edge_features``;
    no hotness reorder)."""
    if edge_feature_data is None:
      return self
    if isinstance(edge_feature_data, dict):
      raise NotImplementedError('heterogeneous edge features come in a '
                                'later slice of the port')
    if split_ratio != 1.0:
      raise NotImplementedError(
          'only the all-device feature table (split_ratio=1.0) is ported; '
          'the host/cold split comes with the UVA slice')
    self.edge_features = Feature(edge_feature_data, self.device, None, dtype)
    return self

  def init_node_labels(self, node_label_data=None):
    if node_label_data is not None:
      self.node_labels = torch.as_tensor(np.asarray(node_label_data)).to(
          self.device)
    return self
