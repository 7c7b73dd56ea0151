"""GraphSAGE, GCN, GAT and the typed RGNN: the plain segment forwards
and the layered, dense forwards.

Counterpart of ``graphlearn_tpu/models/models.py``: ``_tree_blocks``,
``_masked_run_mean`` / ``_masked_flat_run_mean`` and
``_masked_run_softmax`` in the ``RUN_MEAN_IMPL`` / ``RUN_SOFTMAX_IMPL``
layout (``run_impl_decision``), ``TreeSAGEConv``, ``MergeSAGEConv``,
``TreeGATConv``, ``MergeGATConv``, ``GCN``, ``GAT`` (its segment,
layered, tree-dense and merge-dense forwards) and ``GraphSAGE``
either without hop offsets (the segment forward over ``SAGEConv``, with
the ``layers=(lo, hi)`` slice the serving tier runs) or with hop offsets:
the layered segment forward (no dense flag: ``SAGEConv`` over each
layer's node and edge prefix, what node_budget-truncated tree batches
take), or ``tree_dense=True`` or ``merge_dense=True``.

- In a tree batch the children of slot ``s`` of depth block ``d`` are
  the contiguous slots ``[o_d + s*k_d, o_d + (s+1)*k_d)``, so mean
  aggregation is a reshape and a masked mean: no gathers, no scatters.
- In a merge (exact-dedup) batch each hop's edges are ``k``-runs in
  frontier order, and each hop's targets one contiguous block of the
  node buffer, so mean aggregation is one source-row gather, a masked
  reshape-mean and one dense block write per hop.

The typed side (``check_hetero_offsets``, ``hetero_trim``,
``_masked_run_softmax``, ``walk_hetero_records``, ``resolve_hetero_parts``,
``HeteroConv``, ``TreeHeteroConv`` and ``RGNN``) follows the JAX
package's: per-edge-type convs summed per target node type, over the
whole typed batch (the segment forward), each layer's typed prefixes
(hop offsets: the hierarchical forward), or the typed tree and
calibrated merge layouts as dense k-run aggregations
(``tree_dense`` / ``merge_dense``). Edge-type keyed modules are keyed by
the type's string form (``typing.as_str``): ``nn.ModuleDict`` takes
string keys only.

Parameter names follow the flax modules (``conv{i}``, ``lin_self``,
``lin_nbr``; ``embed_{t}``, ``hetero{i}``, ``lin_out``) so
``models.convert`` maps one onto the other. ``dtype`` is
the compute dtype of every conv, as flax's (``conv.dense``): inputs,
aggregation, products and the logits in it, the parameters float32.
"""
import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..typing import as_str
from ..utils import resolve_device
from .conv import GATConv, GCNConv, SAGEConv, dense


def _tree_blocks(node_offsets, fanouts, n_rows):
  """(blocks, edge_offsets) of a tree layout slice, validated against the
  real fanouts (a truncated layout could pass a divisibility check)."""
  no = tuple(node_offsets)
  assert no[-1] == n_rows, (no, n_rows)
  blocks = (no[0],) + tuple(no[i + 1] - no[i] for i in range(len(no) - 1))
  assert fanouts is not None and len(fanouts) >= len(blocks) - 1, (
      'dense-tree convs require the true fanouts to validate the layout')
  eo = [0]
  for d in range(len(blocks) - 1):
    assert blocks[d + 1] == blocks[d] * fanouts[d], (
        'dense-tree aggregation requires un-truncated tree blocks '
        f'(block {d + 1} = {blocks[d + 1]} != parent block '
        f'{blocks[d]} * fanout {fanouts[d]})')
    eo.append(eo[-1] + blocks[d + 1])
  return blocks, eo


def _masked_run_mean(vals, mask):
  """Masked mean over axis 1 of a ``[runs, k, F]`` block."""
  s = torch.where(mask[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                     device=vals.device))
  s = s.sum(1)
  inv = (1.0 / torch.clamp(mask.sum(1), min=1)).to(vals.dtype)
  return s * inv[:, None]


def _impl_from_env(var: str, default: str, allowed) -> str:
  """A run-layout choice read from the environment (``var`` unset or
  empty: ``default``); a value outside ``allowed`` raises."""
  v = os.environ.get(var, '').strip()
  if not v:
    return default
  if v not in allowed:
    raise ValueError(f'{var}={v!r}: expected one of {sorted(allowed)}')
  return v


def run_impl_decision(reshape_ms, window_ms, rel_margin: float = 0.03):
  """The rule that picks a run layout from an A/B timing: 'window' wins
  only by more than ``rel_margin`` (a tie keeps 'reshape'). Returns
  ``(decision, evidence)``; a missing leg gives ``(None, reason)``."""
  if reshape_ms is None or window_ms is None:
    return None, 'undecided: missing ' + (
        'both legs' if reshape_ms is None and window_ms is None else
        ('reshape leg' if reshape_ms is None else 'window leg'))
  if window_ms < reshape_ms * (1.0 - rel_margin):
    return 'window', (f'window {window_ms:.3f} ms beats reshape '
                      f'{reshape_ms:.3f} ms by >{rel_margin:.0%}')
  return 'reshape', (f'reshape {reshape_ms:.3f} ms holds (window '
                     f'{window_ms:.3f} ms, margin {rel_margin:.0%})')


# The layout of the dense convs' k-run reductions (the JAX package's
# GLT_RUN_MEAN_IMPL / GLT_RUN_SOFTMAX_IMPL). 'reshape' (the default)
# reduces over axis 1 of a [runs, k, F] view; 'window' keeps the flat
# [runs*k, F] layout and reduces each run of k rows with
# torch.segment_reduce (lax.reduce_window's row windows), broadcasting
# back with repeat_interleave. The two give the same numbers; on the card
# a view costs nothing, so 'reshape' stays the default.
RUN_MEAN_IMPL = _impl_from_env('GLT_RUN_MEAN_IMPL', 'reshape',
                               ('reshape', 'window'))
RUN_SOFTMAX_IMPL = _impl_from_env('GLT_RUN_SOFTMAX_IMPL', 'reshape',
                                  ('reshape', 'window'))


def _run_reduce(x, k: int, reduce: str):
  """``reduce`` ('max' or 'sum') over each run of ``k`` rows of a flat
  ``[f*k, C]`` tensor: ``[f, C]``."""
  lengths = torch.full((x.shape[0] // k,), k, dtype=torch.int64,
                       device=x.device)
  return torch.segment_reduce(x, reduce, lengths=lengths, axis=0)


def _masked_flat_run_mean(x, mask, k: int):
  """Masked mean over k-runs of a flat ``[f*k, F]`` block, in the
  RUN_MEAN_IMPL layout."""
  f = mask.shape[0]
  if RUN_MEAN_IMPL == 'window':
    xz = torch.where(mask.reshape(-1)[:, None], x,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    inv = (1.0 / torch.clamp(mask.sum(1), min=1)).to(x.dtype)
    return _run_reduce(xz, k, 'sum') * inv[:, None]
  return _masked_run_mean(x.reshape(f, k, -1), mask)


def _masked_run_softmax(e, mask, out_dtype, negative_slope):
  """Masked attention softmax over axis 1 of ``[runs, k, H]`` logits:
  leaky_relu, masked slots to -inf, the true per-run max subtracted (an
  all-masked run: 0), exp, the denominator floored at 1e-9, in the
  RUN_SOFTMAX_IMPL layout. The gradient flows through the max as
  through JAX's; the ``where`` stops it at an all-masked run's -inf."""
  if RUN_SOFTMAX_IMPL == 'window':
    f, k, h = e.shape
    ef = F.leaky_relu(e.reshape(f * k, h), negative_slope)
    mf = mask.reshape(f * k)[:, None]
    ef = torch.where(mf, ef, float('-inf'))
    mx = _run_reduce(ef, k, 'max')
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(mf, torch.exp(ef - mx.repeat_interleave(k, 0)), 0.0)
    denom = torch.clamp(_run_reduce(ex, k, 'sum'), min=1e-9)
    return (ex / denom.repeat_interleave(k, 0)).reshape(f, k, h).to(
        out_dtype)
  e = F.leaky_relu(e, negative_slope)
  e = torch.where(mask[..., None], e, float('-inf'))
  mx = e.amax(1, keepdim=True)
  e = e - torch.where(torch.isfinite(mx), mx, 0.0)
  ex = torch.where(mask[..., None], torch.exp(e), 0.0)
  denom = torch.clamp(ex.sum(1, keepdim=True), min=1e-9)
  return (ex / denom).to(out_dtype)


@torch.no_grad()
def draw_parameters(module, generator: Optional[torch.Generator] = None):
  """The port's initial weights, drawn on the CPU from ``generator`` in
  ``named_parameters`` order: a layer's weight and bias uniform in
  +-1/sqrt(fan_in) (nn.Linear's default), an embedding table standard
  normal, a ``pri_*`` / ``skip_*`` scalar 1 (flax's ones), and any other
  tensor (an attention vector or relation matrix) Glorot uniform with
  flax's fans (leading axes are its receptive field)."""
  for name, p in module.named_parameters():
    owner_name, _, leaf = name.rpartition('.')
    owner = module.get_submodule(owner_name)
    if leaf.startswith(('pri_', 'skip_')):
      p.fill_(1.0)
      continue
    if isinstance(owner, nn.Embedding):
      p.copy_(torch.empty(p.shape).normal_(generator=generator))
      continue
    if leaf in ('weight', 'bias'):
      bound = 1.0 / owner.weight[0].numel() ** 0.5
    else:
      rf = 1
      for s in p.shape[:-2]:
        rf *= s
      bound = (6.0 / ((p.shape[-2] + p.shape[-1]) * rf)) ** 0.5
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                          generator=generator))


def _dynamic_rows(n: int, base, f: int):
  """The ``f`` row indices of ``lax.dynamic_slice_in_dim(a, base, f)``
  over an ``n``-row array: the start (a 0-d device tensor, never read on
  the host) clamped to ``[0, n - f]`` as XLA clamps it."""
  start = torch.clamp(base, 0, max(n - f, 0)).to(torch.int64)
  return start + torch.arange(f, dtype=torch.int64, device=base.device)


class TreeSAGEConv(nn.Module):
  """SAGEConv over tree-positional batches, aggregation as a dense
  reshape (valid only for un-truncated tree batches).

  ``out_rows`` produces only the leading output rows the next layer
  reads (the deepest block is pure child input).
  """

  def __init__(self, in_dim: int, out_dim: int, node_offsets: Sequence[int],
               fanouts: Sequence[int], use_bias: bool = True,
               out_rows: Optional[int] = None, dtype=None):
    super().__init__()
    self.node_offsets = tuple(node_offsets)
    self.fanouts = tuple(fanouts)
    self.out_rows = out_rows
    self.dtype = dtype
    self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
    self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

  def forward(self, x, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    blocks, eo = _tree_blocks(self.node_offsets, self.fanouts, x.shape[0])
    no = self.node_offsets
    r = x.shape[0] if self.out_rows is None else int(self.out_rows)
    aggs = []
    covered = 0
    for d in range(len(blocks) - 1):   # target block d <- child block d+1
      if covered >= r:
        break
      b, k = blocks[d], self.fanouts[d]
      ch = x[no[d]:no[d] + blocks[d + 1]]
      m = edge_mask[eo[d]:eo[d + 1]].reshape(b, k)
      aggs.append(_masked_flat_run_mean(ch, m, k))
      covered += b
    if covered < r:
      # remaining rows are childless in this slice: aggregate = 0
      aggs.append(x.new_zeros((r - covered, x.shape[-1])))
    agg = torch.cat(aggs) if len(aggs) > 1 else aggs[0]
    assert agg.shape[0] == r, (
        f'out_rows={r} must align with the tree block structure '
        f'{no} (got coverage {agg.shape[0]})')
    return dense(self.lin_self, x[:r], self.dtype) + \
        dense(self.lin_nbr, agg, self.dtype)


class MergeSAGEConv(nn.Module):
  """SAGEConv over merge-layout batches: per-hop blocked mean
  aggregation instead of a segment scatter-add.

  The merge engine emits each hop's edges in frontier order (each
  frontier node's ``k`` draws in consecutive slots), and appended each
  hop's frontier as one contiguous block, so a hop's mean aggregate is a
  ``[frontier, k]`` masked reshape-mean written as one dense block at the
  hop's target base. Exact for every merge batch, including calibrated
  caps (dedup expands each node at most once).

  The block write reproduces ``lax.dynamic_update_slice``: its start is
  clamped to ``[0, n - f]``, so a hop without a valid run (base ``n``)
  writes its zero block at ``n - f``; the start stays a device tensor
  (``index_copy_`` at ``clamp(base) + arange(f)``), never read on the
  host. ``out_rows`` produces only the leading rows the next layer reads.
  """

  def __init__(self, in_dim: int, out_dim: int, edge_offsets: Sequence[int],
               fanouts: Sequence[int], use_bias: bool = True,
               out_rows: Optional[int] = None, dtype=None):
    super().__init__()
    self.edge_offsets = tuple(edge_offsets)
    self.fanouts = tuple(fanouts)
    self.out_rows = out_rows
    self.dtype = dtype
    self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
    self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

  def forward(self, x, edge_index, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    n = x.shape[0] if self.out_rows is None else int(self.out_rows)
    row, col = edge_index[0], edge_index[1]
    acc = x.new_zeros((n, x.shape[-1]))
    e0 = 0
    for i, e1 in enumerate(self.edge_offsets):
      k = self.fanouts[i]
      width = e1 - e0
      assert width % k == 0, (
          f'hop {i} edge block {width} not a multiple of fanout {k}; '
          'edge_offsets/fanouts must come from the same plan as the '
          'merge-mode loader (models.train.merge_hop_offsets)')
      f = width // k
      assert f <= n, (f, n)
      m = edge_mask[e0:e1].reshape(f, k)
      # index_select, not x[idx]: the backward of x[idx] on the card
      # serialises each repeated source row (the masked slots' row 0 and
      # the graph's hubs) and cost 23 of a 26 ms train step; index_select
      # scatters its gradient with atomic adds
      src = torch.index_select(x, 0, row[e0:e1].clamp(min=0).long())
      mean = _masked_flat_run_mean(src, m, k)
      # the k-run's target local idx (masked slots carry -1: take max)
      tgt = col[e0:e1].reshape(f, k).max(1).values
      ok = m.any(1) & (tgt >= 0)
      # base from tgt[j] - j: immune to leading all-masked runs
      # (zero-degree frontier nodes read tgt = -1)
      ar = torch.arange(f, dtype=tgt.dtype, device=x.device)
      base = torch.where(ok, tgt - ar, n).min()
      start = torch.clamp(base, 0, n - f).to(torch.int64)
      acc.index_copy_(0, start + ar.to(torch.int64),
                      torch.where(ok[:, None], mean, 0.0))
      e0 = e1
    return dense(self.lin_self, x[:n], self.dtype) + \
        dense(self.lin_nbr, acc, self.dtype)


class TreeGATConv(GATConv):
  """GATConv over tree-positional batches: a dense softmax per parent
  (``graphlearn_tpu/models/models.py:TreeGATConv``).

  In a tree batch every target's in-edges are its contiguous child block,
  so the segment softmax over in-edges is a masked softmax over the
  ``[parents, k]`` reshape: no gathers, no scatters. Every input row gets
  an output row (the deepest block's are zero). A ``GATConv`` (its
  parameters ``lin``, ``att_src``, ``att_dst``) with another forward.
  Valid only for un-truncated layouts (no node_budget).
  """

  def __init__(self, in_dim: int, out_dim: int, node_offsets: Sequence[int],
               fanouts: Sequence[int], heads: int = 1,
               negative_slope: float = 0.2, concat: bool = True,
               dtype=None):
    super().__init__(in_dim, out_dim, heads, negative_slope, concat, dtype)
    self.node_offsets = tuple(node_offsets)
    self.fanouts = tuple(fanouts)

  def forward(self, x, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    no = self.node_offsets
    blocks, eo = _tree_blocks(no, self.fanouts, x.shape[0])
    n, heads, hd = x.shape[0], self.heads, self.out_dim
    w = dense(self.lin, x, self.dtype).reshape(n, heads, hd)
    wf = w.float()
    alpha_src = (wf * self.att_src[None]).sum(-1)       # [n, H]
    alpha_dst = (wf * self.att_dst[None]).sum(-1)
    outs = []
    for d in range(len(blocks) - 1):   # parents block d <- children d+1
      b, k = blocks[d], self.fanouts[d]
      lo = 0 if d == 0 else no[d - 1]
      ch = slice(no[d], no[d] + blocks[d + 1])
      e = alpha_src[ch].reshape(b, k, heads) + alpha_dst[lo:lo + b][:, None]
      m = edge_mask[eo[d]:eo[d + 1]].reshape(b, k)
      attn = _masked_run_softmax(e, m, w.dtype, self.negative_slope)
      msgs = w[ch].reshape(b, k, heads, hd)
      outs.append((msgs * attn[..., None]).sum(1))      # [b, H, D]
    outs.append(w.new_zeros((blocks[-1], heads, hd)))
    out = torch.cat(outs)
    if self.concat:
      return out.reshape(n, heads * hd)
    return out.mean(1)


class MergeGATConv(GATConv):
  """GATConv over merge-layout batches: a dense softmax per target over
  its k-run (``graphlearn_tpu/models/models.py:MergeGATConv``).

  Dedup expands every node at most once, so a target's in-edges are its
  contiguous k-run in the hop that expanded it: per hop, one row gather
  ``w[src]`` of the flat ``[n, heads*D]`` projection, the source alphas
  from the gathered rows and the target alphas from the buffer, a masked
  run softmax, and one dense block WRITE at the hop's base ``min(tgt -
  j)`` over its valid runs (``lax.dynamic_update_slice``: the start
  clamped to ``[0, n - f]``, hops in order, so a later hop overwrites the
  zero rows an earlier one wrote past its runs). It writes, where the
  typed merge convs add. The base stays on the device. A ``GATConv``
  with another forward.
  """

  def __init__(self, in_dim: int, out_dim: int, edge_offsets: Sequence[int],
               fanouts: Sequence[int], heads: int = 1,
               negative_slope: float = 0.2, concat: bool = True,
               dtype=None):
    super().__init__(in_dim, out_dim, heads, negative_slope, concat, dtype)
    self.edge_offsets = tuple(edge_offsets)
    self.fanouts = tuple(fanouts)

  def forward(self, x, edge_index, edge_mask):
    if self.dtype is not None:
      x = x.to(self.dtype)
    n, heads, hd = x.shape[0], self.heads, self.out_dim
    w = dense(self.lin, x, self.dtype)                  # [n, H*D], flat
    alpha_dst = (w.float().reshape(n, heads, hd) * self.att_dst).sum(-1)
    row, col = edge_index[0], edge_index[1]
    acc = w.new_zeros((n, heads * hd))
    e0 = 0
    for i, e1 in enumerate(self.edge_offsets):
      k = self.fanouts[i]
      width = e1 - e0
      assert width % k == 0, (
          f'hop {i} edge block {width} not a multiple of fanout {k}; '
          'build edge_offsets with models.train.merge_hop_offsets')
      f = width // k
      assert f <= n, (f, n)
      src = row[e0:e1].clamp(min=0).to(torch.int64)
      tgt = col[e0:e1].reshape(f, k).amax(1)
      m = edge_mask[e0:e1].reshape(f, k)
      msgs4 = w.index_select(0, src).reshape(f, k, heads, hd)
      e = (msgs4.float() * self.att_src).sum(-1) + \
          alpha_dst.index_select(0, tgt.clamp(min=0).to(torch.int64)
                                 )[:, None]
      attn = _masked_run_softmax(e, m, w.dtype, self.negative_slope)
      outv = (msgs4 * attn[..., None]).sum(1)           # [f, H, D]
      ok = m.any(1) & (tgt >= 0)
      # the block base from tgt[j] - j: a zero-degree frontier node's run
      # is all masked and reads tgt -1, so min(valid tgt) alone would
      # misplace a block such runs lead
      ar = torch.arange(f, dtype=tgt.dtype, device=x.device)
      base = torch.where(ok, tgt - ar, n).amin()
      start = torch.clamp(base, 0, n - f).to(torch.int64)
      acc.index_copy_(0, start + ar.to(torch.int64),
                      torch.where(ok[:, None], outv.reshape(f, heads * hd),
                                  0.0))
      e0 = e1
    if self.concat:
      return acc
    return acc.reshape(n, heads, hd).mean(1)


class GraphSAGE(nn.Module):
  """Multi-layer GraphSAGE.

  Without hop offsets and dense flags it is the plain segment forward:
  every layer is a ``SAGEConv`` over the whole ``edge_index``, and
  ``forward(..., layers=(lo, hi))`` runs only conv layers ``[lo, hi)``
  (the serving tier's materializer and refresh). With hop offsets, layer
  ``l`` processes only the node/edge prefix its depth needs
  (``hop_node_offsets`` / ``hop_edge_offsets``, from
  ``models.train.tree_hop_offsets`` for tree batches or
  ``merge_hop_offsets`` for merge batches, with the loader's
  ``node_budget``): with neither dense flag each layer is a ``SAGEConv``
  over ``x[:n_in]`` and the edge prefix ``[:e_used]`` (the layered
  segment forward; any ``aggr``); ``tree_dense=True`` aggregates with
  ``TreeSAGEConv`` (un-truncated tree batches only), ``merge_dense=True``
  with ``MergeSAGEConv`` (mutually exclusive; both mean-only), and the
  intermediate dense layers produce only the next layer's rows. ReLU
  follows every layer but the last. ``dtype`` is the convs' compute dtype
  (``conv.dense``; the logits come out in it, the parameters stay
  float32). ``device=None`` means the card. Weights are drawn on the CPU
  from ``generator`` (nn.Linear's default distribution) and then moved,
  so a seed gives the same model on every device.
  """

  def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
               num_layers: int = 3, hop_node_offsets=None,
               hop_edge_offsets=None, tree_dense: bool = False,
               merge_dense: bool = False, fanouts=None, aggr: str = 'mean',
               device=None, generator: Optional[torch.Generator] = None,
               dtype=None):
    super().__init__()
    device = resolve_device(device)
    layered = hop_node_offsets is not None
    self.segment = not layered
    self.tree_dense, self.merge_dense = tree_dense, merge_dense
    self.num_layers = num_layers
    self.out_dim = out_dim
    self.dtype = dtype
    if tree_dense or merge_dense:
      if not layered or tree_dense == merge_dense:
        raise ValueError('tree_dense / merge_dense need hop offsets and '
                         'exclude each other')
      if aggr != 'mean':
        raise ValueError('the dense forwards implement mean aggregation')
      assert fanouts is not None, (
          'the dense forwards require the loader fanouts (they guard '
          'against a node_budget-truncated layout)')
    if layered:
      assert hop_edge_offsets is not None and \
          len(hop_node_offsets) >= num_layers + 1 and \
          len(hop_edge_offsets) >= num_layers
      self.hop_node_offsets = tuple(hop_node_offsets)
      self.hop_edge_offsets = tuple(hop_edge_offsets)
    else:
      self.hop_node_offsets = self.hop_edge_offsets = None
    self.fanouts = None if fanouts is None else tuple(fanouts)
    for i in range(num_layers):
      dim_in = in_dim if i == 0 else hidden_dim
      dim = out_dim if i == num_layers - 1 else hidden_dim
      if not (tree_dense or merge_dense):
        conv = SAGEConv(dim_in, dim, aggr=aggr, dtype=dtype)
      else:
        hops_used = num_layers - i
        out_rows = (self.hop_node_offsets[hops_used - 1]
                    if i < num_layers - 1 else None)
        if merge_dense:
          conv = MergeSAGEConv(
              dim_in, dim, self.hop_edge_offsets[:hops_used],
              self.fanouts[:hops_used], out_rows=out_rows, dtype=dtype)
        else:
          conv = TreeSAGEConv(
              dim_in, dim, self.hop_node_offsets[:hops_used + 1],
              self.fanouts[:hops_used], out_rows=out_rows, dtype=dtype)
      self.add_module(f'conv{i}', conv)
    self.reset_parameters(generator)
    self.to(device)

  def convs(self):
    return [getattr(self, f'conv{i}') for i in range(self.num_layers)]

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """nn.Linear's default init (uniform in +-1/sqrt(fan_in)), drawn from
    ``generator`` on the CPU (``draw_parameters``)."""
    draw_parameters(self, generator)

  def forward(self, x, edge_index, edge_mask, layers=None):
    if self.segment:
      # layers=(lo, hi): only conv layers [lo, hi) of the same forward,
      # the serving tier's layer slice
      lo, hi = (0, self.num_layers) if layers is None else layers
      assert 0 <= lo <= hi <= self.num_layers, (layers, self.num_layers)
      for i in range(lo, hi):
        x = getattr(self, f'conv{i}')(x, edge_index, edge_mask)
        if i < self.num_layers - 1:
          x = torch.relu(x)
      return x
    assert layers is None, (
        'layer slices run the plain segment forward — build the serving '
        'model without hop offsets / dense flags')
    # a mismatched batch (another batch_size, fanouts or node_budget, or
    # the other engine's layout) would slice the wrong rows silently
    assert self.hop_node_offsets[self.num_layers] == x.shape[0], (
        f'layered forward: hop offsets {self.hop_node_offsets} do not match '
        f'the batch node buffer ({x.shape[0]}); build them from the same '
        'batch_size/fanouts/node_budget as the loader: '
        'models.train.tree_hop_offsets for tree batches, merge_hop_offsets '
        'for exact-dedup batches')
    for i, conv in enumerate(self.convs()):
      hops_used = self.num_layers - i
      n_in = self.hop_node_offsets[hops_used]
      e_used = self.hop_edge_offsets[hops_used - 1]
      if self.tree_dense:
        x = conv(x[:n_in], edge_mask[:e_used])
      else:
        x = conv(x[:n_in], edge_index[:, :e_used], edge_mask[:e_used])
      if i < self.num_layers - 1:
        x = torch.relu(x)
    return x


class GCN(nn.Module):
  """Multi-layer GCN (``graphlearn_tpu/models/models.py:GCN``): every
  layer a ``GCNConv`` over the whole ``edge_index``, ReLU (and dropout,
  in ``train()`` mode) between. ``forward(..., layers=(lo, hi))`` runs
  only conv layers ``[lo, hi)``. ``device=None`` means the card; weights
  are drawn on the CPU from ``generator`` (``draw_parameters``)."""

  def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
               num_layers: int = 2, dropout: float = 0.0, dtype=None,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    self.num_layers, self.dropout, self.dtype = num_layers, dropout, dtype
    self.out_dim = out_dim
    self.segment = True
    for i in range(num_layers):
      dim_in = in_dim if i == 0 else hidden_dim
      dim = out_dim if i == num_layers - 1 else hidden_dim
      self.add_module(f'conv{i}', GCNConv(dim_in, dim, dtype=dtype))
    draw_parameters(self, generator)
    self.to(device)

  def forward(self, x, edge_index, edge_mask, layers=None):
    lo, hi = (0, self.num_layers) if layers is None else layers
    assert 0 <= lo <= hi <= self.num_layers, (layers, self.num_layers)
    for i in range(lo, hi):
      x = getattr(self, f'conv{i}')(x, edge_index, edge_mask)
      if i < self.num_layers - 1:
        x = torch.relu(x)
        if self.dropout > 0:
          x = F.dropout(x, self.dropout, self.training)
    return x


class GAT(nn.Module):
  """Multi-head GAT stack (``graphlearn_tpu/models/models.py:GAT``).

  Layer ``i`` is a GAT conv of width ``hidden_dim`` per head with
  ``heads`` heads concatenated (so a hidden layer's input is
  ``heads * hidden_dim`` wide), the last of width ``out_dim`` with one
  head, not concatenated; ELU (and dropout, in ``train()`` mode) between.
  Without hop offsets it is the segment forward (``GATConv`` over the
  whole ``edge_index``; ``layers=(lo, hi)`` runs conv layers ``[lo, hi)``,
  the serving tier's slice). With hop offsets each layer runs over the
  node and edge prefix its depth needs: ``GATConv`` (the layered segment
  forward), ``TreeGATConv`` (``tree_dense``, un-truncated tree batches)
  or ``MergeGATConv`` (``merge_dense``, merge batches); the dense ones
  need the loader's ``fanouts``. ``device=None`` means the card; weights
  are drawn on the CPU from ``generator`` (``draw_parameters``).
  """

  def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
               num_layers: int = 2, heads: int = 4, dropout: float = 0.0,
               dtype=None, hop_node_offsets=None, hop_edge_offsets=None,
               tree_dense: bool = False, merge_dense: bool = False,
               fanouts=None, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    layered = hop_node_offsets is not None
    if tree_dense:
      assert layered and fanouts is not None, (
          'tree_dense GAT requires hop offsets + the true fanouts')
    if merge_dense:
      assert layered and not tree_dense and fanouts is not None, (
          'merge_dense GAT requires merge hop offsets + fanouts and is '
          'mutually exclusive with tree_dense')
    if layered:
      assert hop_edge_offsets is not None and \
          len(hop_node_offsets) >= num_layers + 1 and \
          len(hop_edge_offsets) >= num_layers
    self.segment = not layered
    self.tree_dense, self.merge_dense = tree_dense, merge_dense
    self.num_layers, self.heads, self.dropout = num_layers, heads, dropout
    self.out_dim, self.dtype = out_dim, dtype
    self.hop_node_offsets = None if not layered else tuple(hop_node_offsets)
    self.hop_edge_offsets = None if not layered else tuple(hop_edge_offsets)
    self.fanouts = None if fanouts is None else tuple(fanouts)
    for i in range(num_layers):
      last = i == num_layers - 1
      dim = out_dim if last else hidden_dim
      h = 1 if last else heads
      dim_in = in_dim if i == 0 else heads * hidden_dim
      kw = dict(heads=h, concat=not last, dtype=dtype)
      hops_used = num_layers - i
      if tree_dense:
        conv = TreeGATConv(dim_in, dim,
                           self.hop_node_offsets[:hops_used + 1],
                           self.fanouts[:hops_used], **kw)
      elif merge_dense:
        conv = MergeGATConv(dim_in, dim, self.hop_edge_offsets[:hops_used],
                            self.fanouts[:hops_used], **kw)
      else:
        conv = GATConv(dim_in, dim, **kw)
      self.add_module(f'conv{i}', conv)
    draw_parameters(self, generator)
    self.to(device)

  def forward(self, x, edge_index, edge_mask, layers=None):
    layered = not self.segment
    if layers is not None:
      assert not layered, (
          'layer slices run the plain segment forward — build the '
          'serving model without hop offsets / dense flags')
      assert 0 <= layers[0] <= layers[1] <= self.num_layers
    if layered:
      assert self.hop_node_offsets[self.num_layers] == x.shape[0], (
          f'layered GAT: hop offsets {self.hop_node_offsets} do not '
          f'match the batch node buffer ({x.shape[0]}); build them from '
          'the SAME batch_size/fanouts as the loader — '
          'models.train.tree_hop_offsets for tree batches, '
          'merge_hop_offsets for exact-dedup batches')
    for i in range(self.num_layers):
      if layers is not None and not (layers[0] <= i < layers[1]):
        continue
      conv = getattr(self, f'conv{i}')
      if layered:
        hops_used = self.num_layers - i
        n_in = self.hop_node_offsets[hops_used]
        e_used = self.hop_edge_offsets[hops_used - 1]
        if self.tree_dense:
          x = conv(x[:n_in], edge_mask[:e_used])
        else:
          x = conv(x[:n_in], edge_index[:, :e_used], edge_mask[:e_used])
      else:
        x = conv(x, edge_index, edge_mask)
      if i < self.num_layers - 1:
        x = F.elu(x)
        if self.dropout > 0:
          x = F.dropout(x, self.dropout, self.training)
    return x


# ------------------------------------------------------------------ typed


def check_hetero_offsets(x_dict, edge_index_dict, hop_node_offsets,
                         hop_edge_offsets, num_layers):
  """Layout validation of the hierarchical typed forwards: a mismatched
  layout would slice the wrong blocks silently."""
  for t, x in x_dict.items():
    assert t in hop_node_offsets, (
        f'hierarchical forward: batch has node type {t!r} but '
        f'hop_node_offsets only covers {list(hop_node_offsets)}')
    assert len(hop_node_offsets[t]) >= num_layers + 1, (
        f'hierarchical forward: hop_node_offsets for {t!r} has '
        f'{len(hop_node_offsets[t])} entries, need num_layers+1='
        f'{num_layers + 1} — layout fanouts must cover every layer')
    assert hop_node_offsets[t][-1] == x.shape[0], (
        f'hierarchical forward: node offsets for {t!r} '
        f'({hop_node_offsets[t]}) do not match the batch buffer '
        f'({x.shape[0]}); build them with sampler.hetero_tree_layout '
        'from the SAME seed caps/fanouts as the tree-mode loader')
  for et in edge_index_dict:
    assert tuple(et) in hop_edge_offsets, (
        f'hierarchical forward: batch has edge type {tuple(et)!r} but '
        f'hop_edge_offsets only covers {list(hop_edge_offsets)} — '
        'check the edge_dir orientation the layout was built with '
        '(batches key edges by the message-flow/reversed type)')
    assert len(hop_edge_offsets[tuple(et)]) >= num_layers, (
        f'hierarchical forward: hop_edge_offsets for {tuple(et)!r} must '
        f'cover {num_layers} hops')


def hetero_trim(x_dict, edge_index_dict, edge_mask_dict, hop_node_offsets,
                hop_edge_offsets, hops_used):
  """The typed node and edge prefixes layer ``hops_used`` needs."""
  x_in = {t: x[:hop_node_offsets[t][hops_used]] for t, x in x_dict.items()}
  ei = {et: v[:, :hop_edge_offsets[tuple(et)][hops_used - 1]]
        for et, v in edge_index_dict.items()}
  em = {et: v[:hop_edge_offsets[tuple(et)][hops_used - 1]]
        for et, v in edge_mask_dict.items()}
  return x_in, ei, em


def walk_hetero_records(recs, edge_mask_dict, r_out, per_record):
  """The parent-coverage walk over one edge type's typed tree records:
  per hop record its ``[f, k]`` edge-mask block and ``per_record(r, m)``
  (``[f, ...]`` values), with ``('gap', n)`` placeholders where the key
  type's parent axis has no record (an edge type inactive at a hop),
  filled with zeros by ``resolve_hetero_parts``."""
  parts, covered = [], 0
  for r in recs:
    if r['parent_base'] >= r_out:
      break
    f, k = r['fcap'], r['k']
    m = edge_mask_dict[r['out_et']][r['edge_base']:r['edge_base'] + f * k]
    m = m.reshape(f, k)
    if r['parent_base'] > covered:
      parts.append(('gap', r['parent_base'] - covered))
      covered = r['parent_base']
    assert r['parent_base'] == covered, (
        f'hetero tree records for {recs[0]["et"]} overlap parents '
        f'({r["parent_base"]} vs {covered}); build them with '
        'sampler.hetero_tree_blocks from the SAME seed caps/fanouts '
        'as the loader')
    parts.append(per_record(r, m))
    covered += f
  if covered < r_out:
    parts.append(('gap', r_out - covered))
  return parts


def resolve_hetero_parts(parts, feat_shape, dtype, device=None):
  """``('gap', n)`` placeholders as zeros ``[n, *feat_shape]``, the parts
  concatenated along the parent axis (an empty walk: ``[0, ...]``)."""
  if not parts:
    return torch.zeros((0,) + tuple(feat_shape), dtype=dtype, device=device)
  parts = [torch.zeros((p[1],) + tuple(feat_shape), dtype=dtype,
                       device=device)
           if isinstance(p, tuple) else p for p in parts]
  return torch.cat(parts) if len(parts) > 1 else parts[0]


class HeteroConv(nn.Module):
  """Per-edge-type convs summed into per-node-type outputs (an RGNN
  layer). ``convs`` maps an edge type (message direction ``(src, rel,
  dst)``) to its conv; it is kept in a ``ModuleDict`` under the type's
  string form. Each conv sees ``cat([x_dst, x_src])`` with the sources'
  rows shifted by ``n_dst`` and its output sliced to the ``n_dst``
  targets, as in the JAX layer."""

  def __init__(self, convs):
    super().__init__()
    self.etypes = [tuple(et) for et in convs]
    self.convs = nn.ModuleDict({as_str(et): c for et, c in convs.items()})

  def forward(self, x_dict, edge_index_dict, edge_mask_dict):
    out: Dict[str, torch.Tensor] = {}
    for et in self.etypes:
      src_t, _, dst_t = et
      if et not in edge_index_dict or src_t not in x_dict or \
          dst_t not in x_dict:
        continue
      ei = edge_index_dict[et]
      n_dst = x_dict[dst_t].shape[0]
      x_cat = torch.cat([x_dict[dst_t], x_dict[src_t]])
      row = torch.where(ei[0] >= 0, ei[0] + n_dst, -1)
      h = self.convs[as_str(et)](x_cat, torch.stack([row, ei[1]]),
                                 edge_mask_dict[et])[:n_dst]
      out[dst_t] = out[dst_t] + h if dst_t in out else h
    return out


def _dense_etypes(records, in_types):
  """The stored edge types a ``TreeHeteroConv`` over ``records`` gives
  output for, when its input holds the node types ``in_types``: those
  with a record whose key and result types are both in the input (a
  leaf-only type drops out after the first layer), sorted. Their key
  types are the layer's output types."""
  return sorted({r['et'] for recs in records for r in recs
                 if r['res_t'] in in_types and r['key_t'] in in_types})


class TreeHeteroConv(nn.Module):
  """One typed layer over typed tree batches with dense k-run
  aggregation (``graphlearn_tpu/models/models.py:TreeHeteroConv``).

  The typed tree layout (``sampler.hetero_tree_blocks``) puts each
  (hop, edge type)'s children in a contiguous block of the result type's
  buffer, their parents in the key type's frontier block and the edges in
  the emitted type's hop segment, so aggregation per edge type is a
  slice, a reshape and a masked mean (``conv='sage'``) or a masked run
  softmax (``conv='gat'``), summed per target type: ``HeteroConv`` over
  per-edge-type ``SAGEConv`` / ``GATConv`` on the same batch.

  ``mode='merge'``: the same over calibrated exact-dedup batches
  (``hetero_tree_blocks(etype_caps=...)``): children are gathered
  through the edge rows and each record's run block is added at the
  base ``min(tgt - j)`` over its valid runs, computed on the device.

  Parameters per stored edge type ``ename = '__'.join(et)``:
  ``lin_self_{ename}`` / ``lin_nbr_{ename}`` (sage) or ``lin_{ename}``,
  ``att_src_{ename}``, ``att_dst_{ename}`` (gat), for the edge types
  ``_dense_etypes(records, in_types)`` names (flax never creates the
  others). ``out_rows``: per-type output widths (the next layer's
  prefixes).
  """

  def __init__(self, in_dim: int, out_dim: int, records, in_types,
               conv: str = 'sage', heads: int = 1,
               negative_slope: float = 0.2, concat: bool = True,
               dtype=None, out_rows=None, mode: str = 'tree'):
    super().__init__()
    assert mode in ('tree', 'merge') and conv in ('sage', 'gat')
    self.out_dim, self.records = out_dim, tuple(records)
    self.conv, self.heads = conv, heads
    self.negative_slope, self.concat = negative_slope, concat
    self.dtype, self.out_rows, self.mode = dtype, out_rows, mode
    self.etypes = _dense_etypes(self.records, set(in_types))
    for et in self.etypes:
      ename = '__'.join(et)
      if conv == 'sage':
        self.add_module(f'lin_self_{ename}', nn.Linear(in_dim, out_dim))
        self.add_module(f'lin_nbr_{ename}',
                        nn.Linear(in_dim, out_dim, bias=False))
      else:
        self.add_module(f'lin_{ename}',
                        nn.Linear(in_dim, heads * out_dim, bias=False))
        for side in ('src', 'dst'):
          p = nn.Parameter(torch.empty(heads, out_dim))
          nn.init.xavier_uniform_(p)
          self.register_parameter(f'att_{side}_{ename}', p)

  @property
  def out_types(self):
    return {self._recs_of(et)[0]['key_t'] for et in self.etypes}

  def _recs_of(self, et):
    return [r for recs in self.records for r in recs if r['et'] == et]

  def forward(self, x_dict, edge_mask_dict, edge_index_dict=None):
    if self.mode == 'merge':
      assert edge_index_dict is not None, (
          "TreeHeteroConv(mode='merge') gathers children through the "
          'edge rows — pass edge_index_dict')
    if self.dtype is not None:
      x_dict = {t: x.to(self.dtype) for t, x in x_dict.items()}
    rows = {t: (x.shape[0] if self.out_rows is None
                else min(int(self.out_rows[t]), x.shape[0]))
            for t, x in x_dict.items()}
    out = {}
    for et in self.etypes:
      recs = [r for r in self._recs_of(et)
              if r['res_t'] in x_dict and r['key_t'] in x_dict]
      if not recs:
        continue
      if self.mode == 'merge':
        fn = self._gat_et_merge if self.conv == 'gat' else \
            self._sage_et_merge
        t, val = fn(et, recs, x_dict, edge_mask_dict, rows,
                    edge_index_dict)
      else:
        fn = self._gat_et if self.conv == 'gat' else self._sage_et
        t, val = fn(et, recs, x_dict, edge_mask_dict, rows)
      out[t] = out[t] + val if t in out else val
    return out

  # ------------------------------------------------------------ shared

  def _sage_out(self, ename, key_t, x_key, n_rows, agg):
    """The SAGE tail of both modes: the self projection of the output
    prefix plus the neighbour projection of the aggregate."""
    return key_t, dense(getattr(self, f'lin_self_{ename}'), x_key[:n_rows],
                        self.dtype) + \
        dense(getattr(self, f'lin_nbr_{ename}'), agg, self.dtype)

  def _gat_setup(self, ename, key_t, res_ts, x_dict):
    """The GAT preamble of both modes: one projection per participating
    type and separate src / dst alpha maps (a self-relation reads both
    for one type), alphas in float32."""
    heads, hd = self.heads, self.out_dim
    a_src = getattr(self, f'att_src_{ename}')
    a_dst = getattr(self, f'att_dst_{ename}')
    lin = getattr(self, f'lin_{ename}')
    w = {t: dense(lin, x_dict[t], self.dtype) for t in res_ts | {key_t}}
    alpha_src = {t: (w[t].float().reshape(-1, heads, hd) * a_src).sum(-1)
                 for t in res_ts}
    alpha_dst_key = (w[key_t].float().reshape(-1, heads, hd) *
                     a_dst).sum(-1)
    return w, alpha_src, alpha_dst_key

  def _run_messages(self, wch, e, m, f, k):
    """``[f, heads * hd]``: the attention-weighted sum of each run's
    ``k`` child projections."""
    heads, hd = self.heads, self.out_dim
    attn = _masked_run_softmax(e, m, wch.dtype, self.negative_slope)
    msgs = wch.reshape(f, k, heads, hd)
    return (msgs * attn[..., None]).sum(1).reshape(f, heads * hd)

  def _heads_out(self, acc, n_rows):
    if not self.concat:
      acc = acc.reshape(n_rows, self.heads, self.out_dim).mean(1)
    return acc

  # --------------------------------------------------------- tree mode

  def _sage_et(self, et, recs, x_dict, edge_mask_dict, rows):
    ename = '__'.join(et)
    key_t = recs[0]['key_t']

    def per_record(r, m):
      ch = x_dict[r['res_t']][r['child_base']:
                              r['child_base'] + r['fcap'] * r['k']]
      return _masked_flat_run_mean(ch, m, r['k'])

    parts = walk_hetero_records(recs, edge_mask_dict, rows[key_t],
                                per_record)
    x_key = x_dict[key_t]
    agg = resolve_hetero_parts(parts, (x_key.shape[-1],), x_key.dtype,
                               x_key.device)
    return self._sage_out(ename, key_t, x_key, rows[key_t], agg)

  def _gat_et(self, et, recs, x_dict, edge_mask_dict, rows):
    ename = '__'.join(et)
    key_t, res_ts = recs[0]['key_t'], {r['res_t'] for r in recs}
    heads, hd = self.heads, self.out_dim
    w, alpha_src, alpha_dst_key = self._gat_setup(ename, key_t, res_ts,
                                                  x_dict)

    def per_record(r, m):
      f, k, cb, pb = r['fcap'], r['k'], r['child_base'], r['parent_base']
      wch = w[r['res_t']][cb:cb + f * k]
      e = alpha_src[r['res_t']][cb:cb + f * k].reshape(f, k, heads) + \
          alpha_dst_key[pb:pb + f][:, None, :]
      return self._run_messages(wch, e, m, f, k)

    parts = walk_hetero_records(recs, edge_mask_dict, rows[key_t],
                                per_record)
    outv = resolve_hetero_parts(parts, (heads * hd,), w[key_t].dtype,
                                w[key_t].device)
    return key_t, self._heads_out(outv, rows[key_t])

  # -------------------------------------------------------- merge mode

  @staticmethod
  def _run_layout(r, edge_mask_dict, edge_index_dict, n_out):
    """(mask ``[f, k]``, child rows ``[f*k]``, run-target base (0-d),
    run ok ``[f]``) of record ``r``'s edge segment; the base is
    ``min(tgt - j)`` over valid runs (``n_out`` without one), on the
    device."""
    f, k = r['fcap'], r['k']
    lo, hi = r['edge_base'], r['edge_base'] + f * k
    ei = edge_index_dict[r['out_et']]
    m = edge_mask_dict[r['out_et']][lo:hi].reshape(f, k)
    src = torch.clamp(ei[0, lo:hi], min=0).to(torch.int64)
    tgt = ei[1, lo:hi].reshape(f, k).amax(1)
    ok = m.any(1) & (tgt >= 0)
    ar = torch.arange(f, dtype=tgt.dtype, device=tgt.device)
    base = torch.where(ok, tgt - ar, n_out).amin().to(torch.int32)
    return m, src, base, ok

  @staticmethod
  def _acc_add(acc, vals, base):
    """``acc[base:base+f] += vals`` at the clamped dynamic start
    (records of one target type within a hop overlap: an add, not a
    write)."""
    return acc.index_add(0, _dynamic_rows(acc.shape[0], base,
                                          vals.shape[0]), vals)

  def _sage_et_merge(self, et, recs, x_dict, edge_mask_dict, rows,
                     edge_index_dict):
    ename = '__'.join(et)
    key_t = recs[0]['key_t']
    n_out = rows[key_t]
    x_key = x_dict[key_t]
    agg = x_key.new_zeros((n_out, x_key.shape[-1]))
    for r in recs:
      if r['parent_base'] >= n_out:
        break
      m, src, base, ok = self._run_layout(r, edge_mask_dict,
                                          edge_index_dict, n_out)
      mean = _masked_flat_run_mean(x_dict[r['res_t']].index_select(0, src),
                                   m, r['k'])
      agg = self._acc_add(agg, torch.where(ok[:, None], mean, 0.0), base)
    return self._sage_out(ename, key_t, x_key, n_out, agg)

  def _gat_et_merge(self, et, recs, x_dict, edge_mask_dict, rows,
                    edge_index_dict):
    ename = '__'.join(et)
    key_t, res_ts = recs[0]['key_t'], {r['res_t'] for r in recs}
    heads, hd = self.heads, self.out_dim
    w, alpha_src, alpha_dst_key = self._gat_setup(ename, key_t, res_ts,
                                                  x_dict)
    n_out = rows[key_t]
    acc = w[key_t].new_zeros((n_out, heads * hd))
    for r in recs:
      if r['parent_base'] >= n_out:
        break
      f, k = r['fcap'], r['k']
      m, src, base, ok = self._run_layout(r, edge_mask_dict,
                                          edge_index_dict, n_out)
      wch = w[r['res_t']].index_select(0, src)
      a_ch = alpha_src[r['res_t']].index_select(0, src)
      # parents are arithmetic from the base (the engine compacts the
      # frontier), so one clamped slice reads the run alphas
      a_par = alpha_dst_key.index_select(
          0, _dynamic_rows(alpha_dst_key.shape[0], base, f))
      e = a_ch.reshape(f, k, heads) + a_par[:, None, :]
      vals = self._run_messages(wch, e, m, f, k)
      acc = self._acc_add(acc, torch.where(ok[:, None], vals, 0.0), base)
    return key_t, self._heads_out(acc, n_out)


class RGNN(nn.Module):
  """Typed GNN: a per-node-type input projection (``embed_{t}``), then
  ``num_layers`` typed layers with ReLU between, then ``lin_out`` on
  ``out_ntype`` (``graphlearn_tpu/models/models.py:RGNN``; the reference
  IGBH RGNN with 'sage' or 'gat' convs).

  Args:
    etypes: message-direction edge types (the batch's keys; for
      ``edge_dir='out'`` the reversed stored types).
    in_dims: ``{node type: feature width}`` of the batch's featured
      types (torch needs each ``embed_{t}``'s width up front).
    hidden_dim / out_dim / num_layers / conv / heads / out_ntype: as in
      JAX; a GAT layer of width ``dim`` runs ``heads`` heads of
      ``dim // heads``, concatenated.
    hop_node_offsets / hop_edge_offsets: the typed layout
      (``sampler.hetero_tree_layout`` or ``hetero_tree_blocks``, with the
      loader's seed caps and fanouts): the hierarchical forward, each
      layer over the typed prefixes its depth needs.
    tree_dense / merge_dense: ``TreeHeteroConv`` layers in 'tree' or
      'merge' mode over ``tree_records`` (``hetero_tree_blocks``, with
      ``etype_caps`` = the loader's caps for merge); both need the
      offsets.
    dtype: compute dtype (the parameters stay float32).
    device: None means the card. Weights are drawn on the CPU from
      ``generator`` and then moved.

  ``forward(x_dict, edge_index_dict, edge_mask_dict, layers=None,
  embed=True, head=None)``: ``layers=(lo, hi)`` runs conv layers
  ``[lo, hi)`` of the segment forward, ``embed`` gates the input
  projections, ``head`` the final ``lin_out`` (None: when
  ``out_ntype`` is set). Returns ``out_ntype``'s logits or the typed
  dict.
  """

  def __init__(self, etypes, in_dims, hidden_dim: int, out_dim: int,
               num_layers: int = 2, conv: str = 'sage', heads: int = 1,
               out_ntype=None, dtype=None, hop_node_offsets=None,
               hop_edge_offsets=None, tree_dense: bool = False,
               tree_records=None, merge_dense: bool = False, device=None,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    assert conv in ('sage', 'gat'), conv
    assert not (tree_dense and merge_dense)
    self.etypes = [tuple(et) for et in etypes]
    self.num_layers, self.conv, self.heads = num_layers, conv, heads
    self.out_ntype, self.dtype = out_ntype, dtype
    self.hidden_dim, self.out_dim = hidden_dim, out_dim
    self.tree_dense, self.merge_dense = tree_dense, merge_dense
    self.hop_node_offsets = hop_node_offsets
    self.hop_edge_offsets = (None if hop_edge_offsets is None else
                             {tuple(k): v
                              for k, v in hop_edge_offsets.items()})
    if tree_dense or merge_dense:
      assert hop_node_offsets is not None and tree_records is not None, (
          'RGNN dense paths require hop offsets + tree_records '
          '(sampler.hetero_tree_blocks)')
    self.tree_records = tree_records
    for t, f in in_dims.items():
      self.add_module(f'embed_{t}', nn.Linear(f, hidden_dim))
    lin_out = out_ntype is not None
    types = set(in_dims)
    for i in range(num_layers):
      last = i == num_layers - 1
      dim = hidden_dim if (lin_out or not last) else out_dim
      if conv == 'gat':
        assert dim % heads == 0, (
            f'GAT layer width {dim} must be divisible by '
            f'heads={heads} (reference parity: per-head dim = '
            'width // heads)')
        conv_dim = dim // heads
      else:
        conv_dim = dim
      if tree_dense or merge_dense:
        hops_used = num_layers - i
        # output widths: the next layer's typed prefixes
        layer = TreeHeteroConv(
            hidden_dim, conv_dim, tree_records[:hops_used], types,
            conv=conv, heads=heads, concat=True, dtype=dtype,
            out_rows={t: o[hops_used - 1]
                      for t, o in hop_node_offsets.items()},
            mode='merge' if merge_dense else 'tree')
        types = layer.out_types
      else:
        layer = HeteroConv({
            et: SAGEConv(hidden_dim, conv_dim, dtype=dtype)
            if conv == 'sage' else
            GATConv(hidden_dim, conv_dim, heads=heads, concat=True,
                    dtype=dtype)
            for et in self.etypes})
      self.add_module(f'hetero{i}', layer)
    if lin_out:
      self.lin_out = nn.Linear(hidden_dim, out_dim)
    self.reset_parameters(generator)
    self.to(device)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """nn.Linear's default init (uniform in +-1/sqrt(fan_in)) for the
    projections, Glorot uniform for the attention vectors, drawn from
    ``generator`` on the CPU (``draw_parameters``)."""
    draw_parameters(self, generator)

  def flax_scope(self, mods):
    """The flax module path of a torch module path (``models.convert``):
    layer ``i``'s segment conv of the ``j``-th edge type is flax's
    auto-named ``SAGEConv_{i*E + j}`` / ``GATConv_{i*E + j}`` (named in
    construction order, layers a slice skips included)."""
    if len(mods) >= 3 and mods[0].startswith('hetero') and \
        mods[1] == 'convs':
      i = int(mods[0][len('hetero'):])
      j = [as_str(et) for et in self.etypes].index(mods[2])
      cls = 'SAGEConv' if self.conv == 'sage' else 'GATConv'
      return [f'{cls}_{i * len(self.etypes) + j}'] + list(mods[3:])
    return list(mods)

  def forward(self, x_dict, edge_index_dict, edge_mask_dict, layers=None,
              embed: bool = True, head=None):
    hier = self.hop_node_offsets is not None
    dense_mode = self.tree_dense or self.merge_dense
    if layers is not None:
      assert not hier and not dense_mode, (
          'layer slices run the plain segment forward — build the '
          'serving model without hop offsets / dense flags')
      assert 0 <= layers[0] <= layers[1] <= self.num_layers
    if hier:
      check_hetero_offsets(x_dict, edge_index_dict, self.hop_node_offsets,
                           self.hop_edge_offsets, self.num_layers)
    if embed:
      x_dict = {t: dense(getattr(self, f'embed_{t}'), x, self.dtype)
                for t, x in x_dict.items()}
    for i in range(self.num_layers):
      last = i == self.num_layers - 1
      if layers is not None and not (layers[0] <= i < layers[1]):
        continue
      if hier:
        hops_used = self.num_layers - i
        x_in, ei, em = hetero_trim(x_dict, edge_index_dict, edge_mask_dict,
                                   self.hop_node_offsets,
                                   self.hop_edge_offsets, hops_used)
      else:
        x_in, ei, em = x_dict, edge_index_dict, edge_mask_dict
      layer = getattr(self, f'hetero{i}')
      if dense_mode:
        x_dict = layer(x_in, em, ei if self.merge_dense else None)
      else:
        x_dict = layer(x_in, ei, em)
      if not last:
        x_dict = {t: torch.relu(v) for t, v in x_dict.items()}
    if head is None:
      head = self.out_ntype is not None
    if head:
      assert self.out_ntype is not None, 'head=True requires out_ntype'
      return dense(self.lin_out, x_dict[self.out_ntype], self.dtype)
    return x_dict
