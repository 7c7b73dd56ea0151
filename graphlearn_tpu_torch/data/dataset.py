"""Dataset: graph + node and edge features + labels, homogeneous.

Counterpart of ``graphlearn_tpu/data/dataset.py:Dataset``. ``edge_dir``
picks CSR (out-edges) or CSC (in-edges) storage. Node features may be
hotness-reordered (``sort_func``, e.g. ``sort_by_in_degree``) and split
between the device and the host (``split_ratio``), with the ``id2index``
map threaded into the ``Feature`` store. The dataset's ``device`` (None
means the card) is every part's device unless a call names another.
Edge features are keyed by edge id (the graph's ``edge_ids``: the input
position unless given).
"""
import numpy as np
import torch

from ..utils import resolve_device
from .feature import Feature
from .graph import Graph, Topology


def _homogeneous(data, what):
  if isinstance(data, dict):
    raise NotImplementedError(f'heterogeneous {what} come in a later '
                              'slice of the port')


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
    _homogeneous(edge_index, 'graphs')
    topo = Topology(edge_index, edge_ids, edge_weights, input_layout=layout,
                    layout='CSR' if self.edge_dir == 'out' else 'CSC',
                    num_nodes=num_nodes)
    self.graph = Graph(topo, graph_mode, self._device(device))
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
    _homogeneous(node_feature_data, 'features')
    feat = np.asarray(node_feature_data)
    topo = self.graph.topo if isinstance(self.graph, Graph) else None
    if sort_func is not None and id2idx is None and topo is not None:
      feat, id2idx = sort_func(feat, split_ratio, topo)
    self.node_features = Feature(feat, split_ratio, device_group_list,
                                 self._device(device), with_device, id2idx,
                                 dtype)
    return self

  def init_edge_features(self, edge_feature_data=None, split_ratio=1.0,
                         device_group_list=None, device=None,
                         with_device: bool = True, dtype=None):
    """The ``[E, F_e]`` edge-feature store, rows keyed by edge id (no
    hotness reorder)."""
    if edge_feature_data is None:
      return self
    _homogeneous(edge_feature_data, 'edge features')
    self.edge_features = Feature(np.asarray(edge_feature_data), split_ratio,
                                 device_group_list, self._device(device),
                                 with_device, None, dtype)
    return self

  def init_node_labels(self, node_label_data=None):
    if node_label_data is not None:
      self.node_labels = torch.as_tensor(np.asarray(node_label_data)).to(
          self.device)
    return self

  def get_graph(self, etype=None):
    return self.graph

  def get_node_feature(self, ntype=None):
    return self.node_features

  def get_edge_feature(self, etype=None):
    return self.edge_features

  def get_node_label(self, ntype=None):
    return self.node_labels

  def get_node_types(self):
    return None

  def get_edge_types(self):
    return None

  @property
  def is_hetero(self) -> bool:
    return False

  def share_ipc(self):
    """The dataset itself, as in the JAX package: sent through
    ``torch.multiprocessing``, its device tensors travel as CUDA IPC
    handles and each ``Feature`` as its own IPC handle (its host tail in
    shared memory, mapped again by the receiver)."""
    return self
