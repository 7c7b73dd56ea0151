"""Batch containers and the sampler-output transforms.

Counterpart of ``graphlearn_tpu/loader/transform.py`` (``Data``,
``to_data``, ``HeteroData``, ``to_hetero_data``). Batches keep their
padded static shapes with validity masks.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..sampler import HeteroSamplerOutput, SamplerOutput
from ..typing import EdgeType, NodeType


class _MetadataAttrs:
  """Unknown attributes read from ``metadata`` (a link batch's
  ``edge_label_index``, a typed batch's ``seed_inverse_dict``)."""

  def __getattr__(self, item):
    md = object.__getattribute__(self, 'metadata')
    if item in md:
      return md[item]
    raise AttributeError(item)


@dataclass
class Data(_MetadataAttrs):
  """A sampled mini-batch subgraph (fixed-shape + masks).

  node: ``[cap_n]`` global ids (FILL-padded); local index == position.
  node_mask / num_nodes: validity of ``node``.
  edge_index: ``[2, cap_e]`` local (row = message source, col = target).
  edge_mask: ``[cap_e]`` validity.
  x / y: features ``[cap_n, F]`` / labels.
  edge_ids / edge_attr: global edge ids ``[cap_e]`` (``with_edge``) and
    their feature rows.
  batch: ``[B]`` padded seed ids; batch_size: number of real seeds.
  """
  node: Any
  num_nodes: Any = None
  node_mask: Any = None
  edge_index: Any = None
  edge_mask: Any = None
  x: Any = None
  y: Any = None
  edge_ids: Any = None
  edge_attr: Any = None
  batch: Any = None
  batch_size: Optional[int] = None
  num_sampled_nodes: Any = None
  num_sampled_edges: Any = None
  metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class HeteroData(_MetadataAttrs):
  """A typed mini-batch: per-type dicts of ``Data``'s padded payloads
  (``node``, ``num_nodes``, ``x``, ``y``, ``batch`` by node type;
  ``edge_index``, ``edge_mask``, ``edge_ids``, ``edge_attr`` by the
  emitted edge type)."""
  node: Dict[NodeType, Any]
  num_nodes: Dict[NodeType, Any] = None
  edge_index: Dict[EdgeType, Any] = None
  edge_mask: Dict[EdgeType, Any] = None
  x: Dict[NodeType, Any] = None
  y: Dict[NodeType, Any] = None
  edge_ids: Dict[EdgeType, Any] = None
  edge_attr: Dict[EdgeType, Any] = None
  batch: Dict[NodeType, Any] = None
  batch_size: Optional[int] = None
  num_sampled_nodes: Any = None
  num_sampled_edges: Any = None
  metadata: Dict[str, Any] = field(default_factory=dict)


def to_data(out: SamplerOutput, node_feats=None, node_labels=None,
            edge_feats=None, node_mask=None, edge_index=None) -> Data:
  """SamplerOutput -> Data, padding kept. ``node_mask`` / ``edge_index``
  may come precomputed from ``ops.collate_batch``."""
  node = out.node
  if node_mask is None and out.num_nodes is not None:
    node_mask = torch.arange(node.shape[0], device=node.device) < \
        out.num_nodes
  if edge_index is None and out.row is not None:
    edge_index = torch.stack([out.row, out.col])
  return Data(
      node=node, num_nodes=out.num_nodes, node_mask=node_mask,
      edge_index=edge_index, edge_mask=out.edge_mask, x=node_feats,
      y=node_labels, edge_ids=out.edge, edge_attr=edge_feats,
      batch=out.batch, batch_size=out.batch_size,
      num_sampled_nodes=out.num_sampled_nodes,
      num_sampled_edges=out.num_sampled_edges, metadata=dict(out.metadata))


def to_hetero_data(out: HeteroSamplerOutput, node_feats=None,
                   node_labels=None, edge_feats=None) -> HeteroData:
  """HeteroSamplerOutput -> HeteroData, padding kept; ``edge_index`` is
  ``stack([row, col])`` per edge type. ``edge_feats`` is accepted and not
  carried, as in the JAX transform."""
  del edge_feats
  ei = None
  if out.row is not None:
    ei = {et: torch.stack([r, out.col[et]]) for et, r in out.row.items()}
  return HeteroData(
      node=out.node, num_nodes=out.num_nodes, edge_index=ei,
      edge_mask=out.edge_mask, x=node_feats, y=node_labels,
      edge_ids=out.edge, batch=out.batch, batch_size=out.batch_size,
      num_sampled_nodes=out.num_sampled_nodes,
      num_sampled_edges=out.num_sampled_edges, metadata=dict(out.metadata))
