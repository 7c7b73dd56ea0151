"""Batch collation: node mask, edge index, feature and label gathers.

Counterpart of ``graphlearn_tpu/ops/collate.py:collate_batch``. The
feature gather goes through ``ops.gather_rows_hbm`` (the CUDA row-gather
kernel on the card); labels and edge features are plain torch gathers.
"""
import torch

from .gather import gather_rows_hbm


def collate_batch(node, num_nodes, row, col, feats, id2index, labels,
                  edge_feats, edge, label_cap=None):
  """Build the derived batch payloads.

  Args:
    node: ``[cap_n]`` global ids (FILL=-1 padded).
    num_nodes: 0-d valid count.
    row / col: ``[cap_e]`` relabeled endpoints (or None).
    feats: ``[N, F]`` device feature table (or None).
    id2index: ``[N]`` row map applied before the gather (or None).
    labels: ``[N]`` device label table (or None).
    edge_feats / edge: edge-feature table and ``[cap_e]`` global edge ids
      (or None).
    label_cap: gather labels only for the first ``label_cap`` slots (the
      seed block leads the buffer); None = the full buffer.

  Returns a dict with node_mask, edge_index, x, y, edge_attr; padded
  slots gather row/label 0 (masked downstream by node_mask).
  """
  out = {}
  out['node_mask'] = (torch.arange(node.shape[0], device=node.device)
                      < num_nodes)
  out['edge_index'] = (torch.stack([row, col]) if row is not None else None)
  safe = torch.clamp(node, min=0)
  if feats is not None:
    fidx = id2index[safe.long()] if id2index is not None else safe
    out['x'] = gather_rows_hbm(feats, fidx)
  else:
    out['x'] = None
  lsafe = safe if label_cap is None else safe[:label_cap]
  out['y'] = labels[lsafe.long()] if labels is not None else None
  if edge_feats is not None and edge is not None:
    out['edge_attr'] = edge_feats[torch.clamp(edge, min=0).long()]
  else:
    out['edge_attr'] = None
  return out
