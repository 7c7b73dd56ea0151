"""Masked message passing over padded COO batches: the segment forward.

Counterpart of ``graphlearn_tpu/models/conv.py`` (``_masked_targets``,
the ``segment_*_agg`` aggregators and ``SAGEConv``). ``edge_index`` is
``[2, E]`` with ``row`` the message source and ``col`` the target; -1
pads. Aggregation scatters into ``n + 1`` segments and drops the last,
where every invalid edge goes.

``dtype`` (e.g. ``torch.bfloat16``) is the compute dtype, as flax's
``dtype=``: the input is cast to it, the aggregation runs in it, and the
weights and bias are cast to it for the product (``dense``), while the
parameters stay float32 (``nn.Linear`` master weights), so autograd
returns float32 gradients and Adam runs in float32.
"""
import torch
from torch import nn


def dense(lin: nn.Linear, x, dtype=None):
  """flax ``nn.Dense(dtype=dtype)`` over ``lin``'s float32 parameters:
  the product in ``dtype`` (the weight cast to it), then the bias added
  in ``dtype``. ``dtype=None`` computes in the promoted type of the input
  and the parameters, as flax does (a bfloat16 feature table under a
  float32 model: float32)."""
  if dtype is None:
    dtype = torch.promote_types(x.dtype, lin.weight.dtype)
    if x.dtype == dtype == lin.weight.dtype:
      return lin(x)
  y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
  if lin.bias is not None:
    y = y + lin.bias.to(dtype)
  return y


def _masked_targets(col, edge_mask, num_nodes: int):
  """Padded or invalid edges scatter into segment ``num_nodes``
  (dropped)."""
  return torch.where(edge_mask & (col >= 0), col,
                     num_nodes).to(torch.int64)


def segment_mean_agg(msgs, col, edge_mask, num_nodes: int):
  """Mean of edge messages at their target nodes."""
  tgt = _masked_targets(col, edge_mask, num_nodes)
  summed = msgs.new_zeros((num_nodes + 1, msgs.shape[1]))
  summed.index_add_(0, tgt, msgs)
  # counts in f32 (exact for any degree), scaled in the message dtype
  count = torch.zeros(num_nodes + 1, dtype=torch.float32,
                      device=msgs.device)
  count.index_add_(0, tgt, torch.ones(tgt.shape[0], dtype=torch.float32,
                                      device=msgs.device))
  inv = (1.0 / torch.clamp(count[:num_nodes, None], min=1.0)).to(msgs.dtype)
  return summed[:num_nodes] * inv


def segment_sum_agg(msgs, col, edge_mask, num_nodes: int):
  tgt = _masked_targets(col, edge_mask, num_nodes)
  summed = msgs.new_zeros((num_nodes + 1, msgs.shape[1]))
  summed.index_add_(0, tgt, msgs)
  return summed[:num_nodes]


def segment_max_agg(msgs, col, edge_mask, num_nodes: int):
  """Max of edge messages at their targets; a node without messages
  gets 0 (``segment_max``'s -inf, and any non-finite value, zeroed)."""
  tgt = _masked_targets(col, edge_mask, num_nodes)
  out = torch.full((num_nodes + 1, msgs.shape[1]), float('-inf'),
                   dtype=msgs.dtype, device=msgs.device)
  out.scatter_reduce_(0, tgt[:, None].expand_as(msgs), msgs, 'amax')
  out = torch.where(torch.isfinite(out), out, 0.0)
  return out[:num_nodes]


_AGGS = {'mean': segment_mean_agg, 'sum': segment_sum_agg,
         'max': segment_max_agg}


class SAGEConv(nn.Module):
  """GraphSAGE conv: ``lin_self(x_v) + lin_nbr(agg_{u->v} x_u)``.

  Messages are gathered as ``x[max(row, 0)]`` (``index_select``: its
  backward is one ``index_add_``, where advanced indexing's serialises
  the duplicates of a hub row, ~55 ms of a link train step on the card)
  and the slots with ``row < 0`` zeroed in place, so the ``[E, F]``
  message tensor is the only edge-sized float buffer (at full-graph scale
  it dominates device memory).
  """

  def __init__(self, in_dim: int, out_dim: int, aggr: str = 'mean',
               use_bias: bool = True, dtype=None):
    super().__init__()
    if aggr not in _AGGS:
      raise ValueError(f'aggr must be one of {sorted(_AGGS)}, got {aggr!r}')
    self.aggr = aggr
    self.dtype = dtype
    self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
    self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

  def forward(self, x, edge_index, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    n = x.shape[0]
    row, col = edge_index[0], edge_index[1]
    src = x.index_select(0, torch.clamp(row, min=0).to(torch.int64))
    src.masked_fill_((row < 0)[:, None], 0)
    agg = _AGGS[self.aggr](src, col, edge_mask, n)
    del src
    return dense(self.lin_self, x, self.dtype) + \
        dense(self.lin_nbr, agg, self.dtype)
