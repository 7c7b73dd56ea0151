"""Forward and evaluation helpers over loader batches.

Counterpart of ``graphlearn_tpu/models/train.py`` for sampled inference:
``make_forward_fn``, ``make_eval_counts``, ``tree_hop_offsets``,
``merge_hop_offsets`` and ``batch_to_dict``. The model owns its parameters (an ``nn.Module``), so
the functions take the batch only. Training comes with a later slice.
"""
import torch

from ..sampler.neighbor_sampler import (capacity_plan,
                                        merge_layout_from_caps, tree_layout)


def make_forward_fn(model):
  """The forward definition: ``batch dict -> model output``."""

  def forward(batch):
    return model(batch['x'], batch['edge_index'], batch['edge_mask'])

  return forward


def make_eval_counts(model):
  """``batch -> (correct, total)`` over the batch's seed slots, as 0-d
  device tensors (no host sync)."""
  forward = make_forward_fn(model)

  @torch.no_grad()
  def eval_counts(batch):
    logits = forward(batch)
    # seed slots lead both buffers; y may be seed-block-sized
    n = min(logits.shape[0], batch['y'].shape[0])
    seed_mask = (torch.arange(n, device=logits.device)
                 < batch['num_seed_nodes'])
    correct = (logits[:n].argmax(-1) == batch['y'][:n]) & seed_mask
    return correct.sum(), seed_mask.sum()

  return eval_counts


def tree_hop_offsets(batch_cap: int, fanouts):
  """(hop_node_offsets, hop_edge_offsets) for the layered forward over
  tree batches: the sampler's own layout plan."""
  return tree_layout(batch_cap, list(fanouts))


def merge_hop_offsets(batch_cap: int, fanouts, frontier_caps=None):
  """(hop_node_offsets, hop_edge_offsets) for the layered forward over
  merge (exact-dedup) batches: the sampler's own capacity plan and merge
  layout (prefix widths = cumulative clamped frontier caps, edge blocks
  ``caps[i] * k`` wide)."""
  caps = capacity_plan(batch_cap, list(fanouts), frontier_caps)
  return merge_layout_from_caps(caps, list(fanouts))


def batch_to_dict(batch):
  """``loader.Data`` -> the flat dict the forward consumes."""
  num_seed = (batch.num_sampled_nodes[0]
              if batch.num_sampled_nodes is not None else batch.batch_size)
  return dict(x=batch.x, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask, y=batch.y, num_seed_nodes=num_seed)
