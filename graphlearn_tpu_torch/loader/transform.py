"""Batch container and the SamplerOutput -> Data transform.

Counterpart of ``graphlearn_tpu/loader/transform.py`` (``Data``,
``to_data``). Batches keep their padded static shapes with validity
masks.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..sampler import SamplerOutput


@dataclass
class Data:
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

  def __getattr__(self, item):
    md = object.__getattribute__(self, 'metadata')
    if item in md:
      return md[item]
    raise AttributeError(item)


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
