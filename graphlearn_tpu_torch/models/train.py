"""Training, forward and evaluation helpers over loader batches.

Counterpart of ``graphlearn_tpu/models/train.py``: ``TrainState``,
``create_train_state``, ``make_loss_fn``, ``make_train_step`` (with its
``eval_step``), ``make_forward_fn``, ``make_layer_slice_fn``,
``make_eval_counts``, ``tree_hop_offsets``, ``merge_hop_offsets`` and
``batch_to_dict`` (homogeneous and typed batches: a typed model returns
the seed type's logits, so the loss and the steps serve both). The model owns its parameters (an ``nn.Module``), so
the functions take the batch only, and the train state holds the
optimizer and the step count. The optimizer is ``torch.optim.Adam`` with
optax.adam's hyperparameters (b1 0.9, b2 0.999, eps 1e-8): the same
update, its bias corrections placed differently (``models.convert``
carries its moments to and from optax's ``ScaleByAdamState``). On a card
it is built ``capturable``: its step count and bias corrections live in
device tensors, so a CUDA graph of train steps (``loader.ScanTrainer``)
replays the update with the count it reached, not the one it captured.
``train_step`` is capture-safe: ``zero_grad`` drops the gradients (the
backward writes fresh ones), nothing is read back, and the Python
``TrainState.step`` is host bookkeeping that a replaying caller advances
itself. ``make_link_train_step`` is the link prediction step
(``link_batch_to_dict`` its batch dict): dot-product scores of the
``edge_label_index`` pairs under sigmoid binary cross-entropy.
"""
from typing import NamedTuple

import torch

from ..sampler.neighbor_sampler import (capacity_plan,
                                        merge_layout_from_caps, tree_layout)


class TrainState(NamedTuple):
  """The optimizer (over the model's parameters) and the number of steps
  taken. The parameters live in the model; a train step updates them in
  place and returns the state with the step advanced."""
  optimizer: torch.optim.Optimizer
  step: int


def create_train_state(model, lr: float = 3e-3, optimizer=None):
  """``TrainState`` with ``torch.optim.Adam(lr)`` over ``model``'s
  parameters (optax.adam's defaults; capturable when they lie on a card),
  or the given optimizer."""
  if optimizer is None:
    params = list(model.parameters())
    optimizer = torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=any(p.device.type == 'cuda' for p in params))
  return TrainState(optimizer, 0)


def make_forward_fn(model):
  """The forward definition: ``batch dict -> model output``. Extra
  keyword arguments pass through to the model (the layer slice below
  uses this)."""

  def forward(batch, **kwargs):
    return model(batch['x'], batch['edge_index'], batch['edge_mask'],
                 **kwargs)

  return forward


def make_layer_slice_fn(model, lo: int, hi: int, **fixed):
  """Layer-slice view of :func:`make_forward_fn`: run only conv layers
  ``[lo, hi)`` of the same forward (``layers=(lo, hi)`` on the model
  call). ``fixed`` forwards extra call keywords (RGNN's ``embed`` /
  ``head``). The serving tier's materializer and final-layer refresh are
  slices of this forward, not re-implementations."""
  fwd = make_forward_fn(model)

  def slice_fwd(batch):
    return fwd(batch, layers=(lo, hi), **fixed)

  return slice_fwd


def make_loss_fn(model, num_classes: int):
  """Masked seed-slot cross-entropy ``batch -> (loss, acc)`` in float32
  over the common prefix of the logits and ``y`` (seed slots lead both
  buffers), each divided by ``max(#seeds, 1)``.

  The JAX loss one-hots ``y``: a label outside ``[0, num_classes)`` (a
  pad slot's, for one) indexes nothing, its one-hot row is zero and so
  is its cross-entropy. Here the label is clamped before it indexes the
  log-probabilities and such a slot's term is zeroed, so no label ever
  reaches an index out of range (on the card that is a device-side
  assert, which ends the process)."""
  forward = make_forward_fn(model)

  def loss_fn(batch):
    logits = forward(batch).float()
    n = min(logits.shape[0], batch['y'].shape[0])
    logits = logits[:n]
    y = batch['y'][:n].long()
    seed_mask = (torch.arange(n, device=logits.device)
                 < batch['num_seed_nodes'])
    known = (y >= 0) & (y < num_classes)
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(1, y.clamp(0, num_classes - 1)[:, None])[:, 0]
    ce = torch.where(seed_mask & known, -picked, 0.0)
    seeds = torch.clamp(seed_mask.sum(), min=1).float()
    loss = ce.sum() / seeds
    correct = (logits.argmax(-1) == y) & seed_mask
    acc = correct.sum().float() / seeds
    return loss, acc

  return loss_fn


def make_train_step(model, num_classes: int):
  """``(train_step, eval_step)``. ``train_step(state, batch)`` computes
  the loss, back-propagates it and takes one optimizer step (the model's
  parameters change in place); it returns ``(state, loss, acc)`` with
  ``loss`` and ``acc`` as detached 0-d device tensors, so no step reads
  anything back to the host. ``eval_step(state, batch)`` is the batch
  accuracy without a gradient."""
  return _steps(make_loss_fn(model, num_classes))


def _steps(loss_fn):
  """``(train_step, eval_step)`` over ``loss_fn: batch -> (loss, acc)``."""

  def train_step(state: TrainState, batch):
    state.optimizer.zero_grad()
    loss, acc = loss_fn(batch)
    loss.backward()
    state.optimizer.step()
    return state._replace(step=state.step + 1), loss.detach(), acc.detach()

  @torch.no_grad()
  def eval_step(state: TrainState, batch):
    return loss_fn(batch)[1]

  return train_step, eval_step


def make_link_loss_fn(model):
  """``batch -> (loss, acc)`` of link prediction
  (``graphlearn_tpu/models/train.py:make_link_train_step``): the score of
  a pair is the dot product of its endpoints' outputs (float32), the loss
  optax's ``sigmoid_binary_cross_entropy`` against ``edge_label`` (1 for
  positives, 0 for sampled negatives), and the accuracy the share of
  pairs whose score's sign matches the label; pairs with a -1 index are
  excluded, and both are divided by ``max(#valid pairs, 1)``."""
  forward = make_forward_fn(model)

  def loss_fn(batch):
    h = forward(batch).float()
    eli = batch['edge_label_index']
    lab = batch['edge_label'].float()
    valid = (eli[0] >= 0) & (eli[1] >= 0)
    # index_select: its backward is one index_add_, not a serial scatter
    src = h.index_select(0, eli[0].clamp(min=0).long())
    dst = h.index_select(0, eli[1].clamp(min=0).long())
    score = (src * dst).sum(-1)
    bce = -lab * torch.nn.functional.logsigmoid(score) - \
        (1.0 - lab) * torch.nn.functional.logsigmoid(-score)
    pairs = torch.clamp(valid.sum(), min=1).float()
    loss = torch.where(valid, bce, 0.0).sum() / pairs
    hit = ((score > 0) == (lab > 0.5)) & valid
    return loss, hit.sum().float() / pairs

  return loss_fn


def make_link_train_step(model):
  """``(train_step, eval_step)`` of link prediction, with the contract of
  :func:`make_train_step` (``eval_step`` gives the accuracy)."""
  return _steps(make_link_loss_fn(model))


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


def tree_hop_offsets(batch_cap: int, fanouts, node_budget=None):
  """(hop_node_offsets, hop_edge_offsets) for the layered forward over
  tree batches: the sampler's own layout plan (``node_budget`` as the
  loader's)."""
  return tree_layout(batch_cap, list(fanouts), node_budget)


def merge_hop_offsets(batch_cap: int, fanouts, node_budget=None,
                      frontier_caps=None):
  """(hop_node_offsets, hop_edge_offsets) for the layered forward over
  merge (exact-dedup) batches: the sampler's own capacity plan and merge
  layout (prefix widths = cumulative clamped frontier caps, edge blocks
  ``caps[i] * k`` wide)."""
  caps = capacity_plan(batch_cap, list(fanouts), node_budget, frontier_caps)
  return merge_layout_from_caps(caps, list(fanouts))


def link_batch_to_dict(batch):
  """A link loader's ``loader.Data`` -> the link step's dict."""
  return dict(x=batch.x, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask,
              edge_label_index=batch.metadata['edge_label_index'],
              edge_label=batch.metadata['edge_label'])


def batch_to_dict(batch, ntype=None):
  """``loader.Data`` -> the flat dict the forward consumes. A typed
  ``loader.HeteroData`` keeps its per-type ``x`` / ``edge_index`` /
  ``edge_mask`` dicts (the typed model's inputs) and gives the seed
  type's labels and seed count (``ntype``, default: the batch's seed
  type), so the loss reads the seed type's logits, whose leading rows
  are the seeds in every typed forward (the hierarchical one emits only
  that prefix)."""
  if isinstance(batch.node, dict):
    if ntype is None:
      (ntype,) = batch.batch
    return dict(x=batch.x, edge_index=batch.edge_index,
                edge_mask=batch.edge_mask, y=batch.y[ntype],
                num_seed_nodes=batch.num_sampled_nodes[ntype][0])
  num_seed = (batch.num_sampled_nodes[0]
              if batch.num_sampled_nodes is not None else batch.batch_size)
  return dict(x=batch.x, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask, y=batch.y, num_seed_nodes=num_seed)
