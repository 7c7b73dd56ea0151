"""Masked message passing over padded COO batches: the segment forward.

Counterpart of ``graphlearn_tpu/models/conv.py`` (``_masked_targets``,
the ``segment_*_agg`` aggregators, ``SAGEConv``, ``GCNConv`` and
``GATConv``).
``edge_index`` is ``[2, E]`` with ``row`` the message source and ``col``
the target; -1 pads. Aggregation scatters into ``n + 1`` segments and drops the last,
where every invalid edge goes.

``dtype`` (e.g. ``torch.bfloat16``) is the compute dtype, as flax's
``dtype=``: the input is cast to it, the aggregation runs in it, and the
weights and bias are cast to it for the product (``dense``), while the
parameters stay float32 (``nn.Linear`` master weights), so autograd
returns float32 gradients and Adam runs in float32.
"""
import torch
import torch.nn.functional as F
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


class GCNConv(nn.Module):
  """GCN conv: symmetric degree normalisation with implicit self loops
  (``graphlearn_tpu/models/conv.py:GCNConv``).

  The degrees count the valid edges in float32 whatever the compute
  dtype, ``deg_in`` over the targets and ``deg_out`` over the sources,
  each plus 1 (the self loop). An edge's message is ``h_src`` scaled by
  ``1 / sqrt(deg_out[src] * deg_in[dst])``; the self loop adds
  ``h / deg_in``. ``lin`` is flax's auto-named ``Dense_0``
  (``flax_names``, read by ``models.convert``)."""

  flax_names = {'lin': 'Dense_0'}

  def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
               dtype=None):
    super().__init__()
    self.dtype = dtype
    self.lin = nn.Linear(in_dim, out_dim, bias=use_bias)

  def forward(self, x, edge_index, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    n = x.shape[0]
    row, col = edge_index[0], edge_index[1]
    tgt = _masked_targets(col, edge_mask, n)
    srcseg = _masked_targets(row, edge_mask, n)
    ones = torch.ones(tgt.shape[0], dtype=torch.float32, device=x.device)
    deg_in = torch.zeros(n + 1, dtype=torch.float32, device=x.device
                         ).index_add_(0, tgt, ones)[:n] + 1.0
    deg_out = torch.zeros(n + 1, dtype=torch.float32, device=x.device
                          ).index_add_(0, srcseg, ones)[:n] + 1.0
    h = dense(self.lin, x, self.dtype)
    safe_row = torch.clamp(row, min=0).to(torch.int64)
    safe_col = torch.clamp(col, min=0).to(torch.int64)
    inv_src = (1.0 / torch.sqrt(deg_out)).index_select(0, safe_row)
    inv_dst = (1.0 / torch.sqrt(deg_in)).index_select(0, safe_col)
    norm = (inv_src * inv_dst).to(h.dtype)
    msgs = h.index_select(0, safe_row) * norm[:, None]
    msgs = torch.where(edge_mask[:, None], msgs,
                       torch.zeros((), dtype=h.dtype, device=h.device))
    agg = msgs.new_zeros((n + 1, h.shape[1])).index_add_(0, tgt, msgs)[:n]
    return agg + h * (1.0 / deg_in[:, None]).to(h.dtype)


def segment_softmax_max(e, tgt, num_segments: int):
  """Per-segment max of ``[E, H]`` logits (``segment_max``), an empty
  segment's -inf and any non-finite max set to 0: the shift of a
  segment softmax. The gradient flows through it as through JAX's
  ``segment_max`` (to the maximal logits; the ``where`` stops it at an
  empty segment's -inf)."""
  mx = torch.full((num_segments, e.shape[1]), float('-inf'),
                  dtype=e.dtype, device=e.device)
  mx = mx.scatter_reduce(0, tgt[:, None].expand_as(e), e, 'amax')
  return torch.where(torch.isfinite(mx), mx, 0.0)


class GATConv(nn.Module):
  """Graph attention conv: multi-head, a masked segment softmax per
  target (``graphlearn_tpu/models/conv.py:GATConv``).

  ``lin`` projects to ``heads * out_dim`` (no bias); ``att_src`` /
  ``att_dst`` (``[heads, out_dim]``) score an edge as
  ``leaky_relu(<w_src, att_src> + <w_dst, att_dst>)`` in float32, the
  softmax shifted by each target's true max (an empty target: 0).
  Messages ``w_src * attn`` are summed per target; ``concat`` joins the
  heads, else they are averaged."""

  def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
               negative_slope: float = 0.2, concat: bool = True,
               dtype=None):
    super().__init__()
    self.out_dim, self.heads = out_dim, heads
    self.negative_slope = negative_slope
    self.concat = concat
    self.dtype = dtype
    self.lin = nn.Linear(in_dim, heads * out_dim, bias=False)
    self.att_src = nn.Parameter(torch.empty(heads, out_dim))
    self.att_dst = nn.Parameter(torch.empty(heads, out_dim))
    nn.init.xavier_uniform_(self.att_src)
    nn.init.xavier_uniform_(self.att_dst)

  def forward(self, x, edge_index, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    n = x.shape[0]
    heads, hd = self.heads, self.out_dim
    row, col = edge_index[0], edge_index[1]
    safe_row = torch.clamp(row, min=0).to(torch.int64)
    safe_col = torch.clamp(col, min=0).to(torch.int64)
    w = dense(self.lin, x, self.dtype).reshape(n, heads, hd)
    # attention logits and softmax in float32; messages in w's dtype
    wf = w.float()
    alpha_src = (wf * self.att_src[None]).sum(-1)     # [N, H]
    alpha_dst = (wf * self.att_dst[None]).sum(-1)
    e = alpha_src.index_select(0, safe_row) + \
        alpha_dst.index_select(0, safe_col)
    e = F.leaky_relu(e, self.negative_slope)
    tgt = _masked_targets(col, edge_mask, n)
    e = torch.exp(e - segment_softmax_max(e, tgt, n + 1)[tgt])
    e = torch.where(edge_mask[:, None], e, 0.0)
    denom = e.new_zeros((n + 1, heads)).index_add_(0, tgt, e)
    attn = (e / torch.clamp(denom[tgt], min=1e-9)).to(w.dtype)
    msgs = w.index_select(0, safe_row) * attn[:, :, None]    # [E, H, D]
    msgs = torch.where(edge_mask[:, None, None], msgs,
                       torch.zeros((), dtype=w.dtype, device=w.device))
    out = msgs.new_zeros((n + 1, heads, hd)).index_add_(0, tgt, msgs)[:n]
    if self.concat:
      return out.reshape(n, heads * hd)
    return out.mean(1)
