"""Sampler input/output containers.

Counterpart of ``graphlearn_tpu/sampler/base.py`` (``NodeSamplerInput``,
``EdgeSamplerInput``, ``NegativeSampling``, ``NeighborOutput``,
``SamplerOutput``, ``HeteroSamplerOutput``, and the producers'
``SamplingType``, ``SamplingConfig``, ``RemoteSamplerInput`` and
``RemoteNodePathSamplerInput``). Outputs are fixed-shape and
mask-padded: ``node`` / ``row`` / ``col`` are padded to static
capacities, validity rides in ``edge_mask`` and the 0-d ``num_nodes``
tensor.
"""
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..typing import EdgeType, NodeType
from ..utils.mixin import CastMixin


def _host(v):
  return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class SamplingType(enum.Enum):
  """What a producer samples from its seeds (JAX's enum)."""
  NODE = 0
  LINK = 1
  SUBGRAPH = 2
  RANDOM_WALK = 3


@dataclass
class SamplingConfig:
  """The options a sampling producer's workers run with."""
  sampling_type: SamplingType
  num_neighbors: Optional[Union[List[int], Dict[EdgeType, List[int]]]]
  batch_size: int
  shuffle: bool = False
  drop_last: bool = False
  with_edge: bool = False
  collect_features: bool = False
  with_neg: bool = False
  with_weight: bool = False
  edge_dir: str = 'out'
  seed: Optional[int] = None


@dataclass
class NodeSamplerInput:
  """Seed nodes for node-based sampling."""
  node: np.ndarray
  input_type: Optional[str] = None

  def __len__(self):
    return int(np.asarray(self.node).shape[0])


@dataclass
class NegativeSampling(CastMixin):
  """Negative sampling: ``mode`` 'binary' (negatives are extra supervision
  pairs labelled 0) or 'triplet' (``amount`` dst candidates per positive
  for a margin loss); ``amount`` negatives per positive."""
  mode: str = 'binary'
  amount: Union[int, float] = 1

  def __post_init__(self):
    if self.mode not in ('binary', 'triplet'):
      raise ValueError(f'unknown negative sampling mode {self.mode!r}')
    if self.amount <= 0:
      raise ValueError('negative sampling amount must be positive')

  def is_binary(self) -> bool:
    return self.mode == 'binary'

  def is_triplet(self) -> bool:
    return self.mode == 'triplet'

  def num_negatives(self, num_pos: int) -> int:
    return int(np.ceil(self.amount * num_pos))


@dataclass
class EdgeSamplerInput(CastMixin):
  """Seed edges for link sampling: ``row`` / ``col`` host arrays, optional
  labels, the edge type (heterogeneous graphs) and the negative
  sampling."""
  row: np.ndarray
  col: np.ndarray
  label: Optional[np.ndarray] = None
  input_type: Optional[EdgeType] = None
  neg_sampling: Optional[NegativeSampling] = None

  def __len__(self):
    return int(np.asarray(self.row).shape[0])

  def __getitem__(self, index) -> 'EdgeSamplerInput':
    return EdgeSamplerInput(
        np.asarray(self.row)[index], np.asarray(self.col)[index],
        np.asarray(self.label)[index] if self.label is not None else None,
        self.input_type, self.neg_sampling)


@dataclass
class NeighborOutput:
  """One hop's dense result: ``nbrs [B, K]`` (FILL-padded), ``mask`` and,
  with ``with_edge``, the global edge ids ``edges [B, K]`` (-1 where
  masked)."""
  nbrs: Any
  mask: Any
  edges: Optional[Any] = None

  @property
  def nbrs_num(self):
    return self.mask.sum(1)


@dataclass
class SamplerOutput:
  """Multi-hop subgraph sample.

  node: ``[cap_n]`` global ids, position == local index, FILL-padded.
  num_nodes: 0-d count of valid slots.
  row / col: ``[cap_e]`` local endpoints (row = message source), -1 where
    invalid. edge_mask: ``[cap_e]`` validity.
  batch: ``[B]`` padded seed ids; batch_size: number of real seeds.
  num_sampled_nodes / num_sampled_edges: per-hop 0-d counts.
  """
  node: Any
  num_nodes: Any = None
  row: Any = None
  col: Any = None
  edge: Optional[Any] = None
  edge_mask: Any = None
  batch: Optional[Any] = None
  batch_size: Optional[int] = None
  num_sampled_nodes: Optional[List[Any]] = None
  num_sampled_edges: Optional[List[Any]] = None
  input_type: Optional[str] = None
  metadata: Dict[str, Any] = field(default_factory=dict)
  device: Any = None

  def trim(self) -> 'SamplerOutput':
    """Exact-size numpy arrays at the host boundary (the padding
    dropped; local indices stay valid because padding occupies the
    tail), as ``graphlearn_tpu/sampler/base.py:SamplerOutput.trim``."""
    host = _host
    node = host(self.node)
    n = int(self.num_nodes) if self.num_nodes is not None else node.shape[0]
    out = SamplerOutput(node=node[:n], num_nodes=n,
                        input_type=self.input_type,
                        batch_size=self.batch_size, metadata=self.metadata)
    if self.row is not None:
      row, col = host(self.row), host(self.col)
      mask = host(self.edge_mask) if self.edge_mask is not None else \
          (row >= 0)
      mask = mask & (row >= 0) & (col >= 0)
      out.row, out.col = row[mask], col[mask]
      if self.edge is not None:
        out.edge = host(self.edge)[mask]
      out.edge_mask = None
    if self.batch is not None:
      out.batch = host(self.batch)
    if self.num_sampled_nodes is not None:
      out.num_sampled_nodes = [int(x) for x in self.num_sampled_nodes]
    if self.num_sampled_edges is not None:
      out.num_sampled_edges = [int(x) for x in self.num_sampled_edges]
    return out


@dataclass
class HeteroSamplerOutput(CastMixin):
  """Typed multi-hop sample: per-node-type node buffers (``node``,
  ``num_nodes``, ``num_sampled_nodes`` keyed by ``NodeType``) and
  per-edge-type relabelled COO (``row``, ``col``, ``edge``, ``edge_mask``,
  ``num_sampled_edges`` keyed by the emitted ``EdgeType``), padded as
  ``SamplerOutput``'s."""
  node: Dict[NodeType, Any]
  num_nodes: Dict[NodeType, Any] = None
  row: Dict[EdgeType, Any] = None
  col: Dict[EdgeType, Any] = None
  edge: Optional[Dict[EdgeType, Any]] = None
  edge_mask: Dict[EdgeType, Any] = None
  batch: Optional[Dict[NodeType, Any]] = None
  batch_size: Optional[int] = None
  num_sampled_nodes: Optional[Dict[NodeType, List[Any]]] = None
  num_sampled_edges: Optional[Dict[EdgeType, List[Any]]] = None
  input_type: Optional[Union[NodeType, EdgeType]] = None
  metadata: Dict[str, Any] = field(default_factory=dict)
  device: Any = None

  def trim(self) -> 'HeteroSamplerOutput':
    """Exact-size numpy arrays per type, the padding dropped (as
    ``graphlearn_tpu/sampler/base.py:HeteroSamplerOutput.trim``)."""
    node, num_nodes = {}, {}
    for t, buf in self.node.items():
      buf = _host(buf)
      n = (int(self.num_nodes[t]) if self.num_nodes is not None
           else buf.shape[0])
      node[t], num_nodes[t] = buf[:n], n
    out = HeteroSamplerOutput(node=node, num_nodes=num_nodes,
                              input_type=self.input_type,
                              batch_size=self.batch_size,
                              metadata=self.metadata)
    if self.row is not None:
      out.row, out.col, out.edge = {}, {}, ({} if self.edge else None)
      for et, row in self.row.items():
        row = _host(row)
        col = _host(self.col[et])
        mask = (_host(self.edge_mask[et]) if self.edge_mask is not None
                else np.ones_like(row, bool))
        mask = mask & (row >= 0) & (col >= 0)
        out.row[et], out.col[et] = row[mask], col[mask]
        if self.edge is not None and self.edge.get(et) is not None:
          out.edge[et] = _host(self.edge[et])[mask]
      out.edge_mask = None
    if self.batch is not None:
      out.batch = {t: _host(v) for t, v in self.batch.items()}
    return out


class RemoteSamplerInput(CastMixin):
  """A seed source that lives on the sampling server."""

  def to_input(self):
    raise NotImplementedError


class RemoteNodePathSamplerInput(RemoteSamplerInput):
  """Seeds the server loads from a ``.npy`` file path of its own."""

  def __init__(self, node_path: str, input_type: Optional[NodeType] = None):
    self.node_path = node_path
    self.input_type = input_type

  def to_input(self) -> NodeSamplerInput:
    seeds = np.load(self.node_path)
    return NodeSamplerInput(seeds, self.input_type)


class BaseSampler:
  """Abstract sampler (``graphlearn_tpu/sampler/base.py:BaseSampler``):
  the sampling entry points, and the checkpoint hooks the loaders
  delegate to. The default is stateless, and refuses to restore another
  sampler's state."""

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError

  def sample_from_edges(self, inputs: EdgeSamplerInput, **kwargs):
    raise NotImplementedError

  def subgraph(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError

  def state_dict(self):
    """PRNG/iteration state for checkpoint-resume. Default: stateless."""
    return {}

  def load_state_dict(self, state):
    if state:
      raise ValueError(
          f'{type(self).__name__} has no state to restore, but the '
          f'checkpoint carries sampler state {sorted(state)}: it was '
          'written by a different sampler type; resuming would diverge')
