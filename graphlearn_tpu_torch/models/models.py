"""GraphSAGE over tree and merge batches (the layered, dense forwards).

Counterpart of ``graphlearn_tpu/models/models.py``: ``_tree_blocks``,
``_masked_run_mean`` / ``_masked_flat_run_mean`` (the 'reshape'
implementation), ``TreeSAGEConv``, ``MergeSAGEConv`` and ``GraphSAGE``
with hop offsets and ``tree_dense=True`` or ``merge_dense=True``.

- In a tree batch the children of slot ``s`` of depth block ``d`` are
  the contiguous slots ``[o_d + s*k_d, o_d + (s+1)*k_d)``, so mean
  aggregation is a reshape and a masked mean: no gathers, no scatters.
- In a merge (exact-dedup) batch each hop's edges are ``k``-runs in
  frontier order, and each hop's targets one contiguous block of the
  node buffer, so mean aggregation is one source-row gather, a masked
  reshape-mean and one dense block write per hop.

Parameter names follow the flax modules (``conv{i}``, ``lin_self``,
``lin_nbr``) so ``models.convert`` maps one onto the other.
"""
from typing import Optional, Sequence

import torch
from torch import nn

from ..utils import resolve_device


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


def _masked_flat_run_mean(x, mask, k: int):
  """Masked mean over k-runs of a flat ``[f*k, F]`` block."""
  f = mask.shape[0]
  return _masked_run_mean(x.reshape(f, k, -1), mask)


class TreeSAGEConv(nn.Module):
  """SAGEConv over tree-positional batches, aggregation as a dense
  reshape (valid only for un-truncated tree batches).

  ``out_rows`` produces only the leading output rows the next layer
  reads (the deepest block is pure child input).
  """

  def __init__(self, in_dim: int, out_dim: int, node_offsets: Sequence[int],
               fanouts: Sequence[int], use_bias: bool = True,
               out_rows: Optional[int] = None):
    super().__init__()
    self.node_offsets = tuple(node_offsets)
    self.fanouts = tuple(fanouts)
    self.out_rows = out_rows
    self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
    self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

  def forward(self, x, edge_mask):
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
    return self.lin_self(x[:r]) + self.lin_nbr(agg)


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
               out_rows: Optional[int] = None):
    super().__init__()
    self.edge_offsets = tuple(edge_offsets)
    self.fanouts = tuple(fanouts)
    self.out_rows = out_rows
    self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
    self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

  def forward(self, x, edge_index, edge_mask):
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
      mean = _masked_flat_run_mean(x[row[e0:e1].clamp(min=0).long()], m, k)
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
    return self.lin_self(x[:n]) + self.lin_nbr(acc)


class GraphSAGE(nn.Module):
  """Multi-layer GraphSAGE with a layered dense forward.

  Layer ``l`` processes only the node/edge prefix its depth needs
  (``hop_node_offsets`` / ``hop_edge_offsets``, from
  ``models.train.tree_hop_offsets`` for tree batches or
  ``merge_hop_offsets`` for merge batches), and intermediate layers
  produce only the next layer's rows. ``tree_dense=True`` aggregates
  with ``TreeSAGEConv``, ``merge_dense=True`` with ``MergeSAGEConv``
  (mutually exclusive). ``device=None`` means the card. Weights are
  drawn on the CPU from ``generator`` (nn.Linear's default distribution)
  and then moved, so a seed gives the same model on every device.

  Only the two dense mean forwards are ported; the segment (edge_index
  scatter) forward comes later.
  """

  def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
               num_layers: int = 3, hop_node_offsets=None,
               hop_edge_offsets=None, tree_dense: bool = False,
               merge_dense: bool = False, fanouts=None, aggr: str = 'mean',
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    if tree_dense == merge_dense or hop_node_offsets is None or \
        aggr != 'mean':
      raise NotImplementedError(
          'GraphSAGE: the port has the layered tree_dense and merge_dense '
          'mean forwards (one of them, with hop offsets and fanouts); the '
          'segment forward comes later')
    assert fanouts is not None, (
        'the dense forwards require the loader fanouts')
    assert len(hop_node_offsets) >= num_layers + 1 and \
        len(hop_edge_offsets) >= num_layers
    self.merge_dense = merge_dense
    self.num_layers = num_layers
    self.hop_node_offsets = tuple(hop_node_offsets)
    self.hop_edge_offsets = tuple(hop_edge_offsets)
    self.fanouts = tuple(fanouts)
    for i in range(num_layers):
      dim_in = in_dim if i == 0 else hidden_dim
      dim = out_dim if i == num_layers - 1 else hidden_dim
      hops_used = num_layers - i
      out_rows = (self.hop_node_offsets[hops_used - 1]
                  if i < num_layers - 1 else None)
      if merge_dense:
        conv = MergeSAGEConv(dim_in, dim, self.hop_edge_offsets[:hops_used],
                             self.fanouts[:hops_used], out_rows=out_rows)
      else:
        conv = TreeSAGEConv(dim_in, dim,
                            self.hop_node_offsets[:hops_used + 1],
                            self.fanouts[:hops_used], out_rows=out_rows)
      self.add_module(f'conv{i}', conv)
    self.reset_parameters(generator)
    self.to(device)

  def convs(self):
    return [getattr(self, f'conv{i}') for i in range(self.num_layers)]

  @torch.no_grad()
  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """nn.Linear's default init (uniform in +-1/sqrt(fan_in)), drawn from
    ``generator`` on the CPU."""
    for p_name, p in self.named_parameters():
      fan_in = p.shape[-1] if p.dim() == 2 else None
      if fan_in is None:   # bias: its layer's fan_in
        layer = self.get_submodule(p_name.rsplit('.', 1)[0])
        fan_in = layer.in_features
      bound = 1.0 / fan_in ** 0.5
      p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                            generator=generator))

  def forward(self, x, edge_index, edge_mask):
    assert self.hop_node_offsets[self.num_layers] == x.shape[0], (
        f'layered forward: hop offsets {self.hop_node_offsets} do not match '
        f'the batch node buffer ({x.shape[0]}); build them with '
        'models.train.tree_hop_offsets (tree batches) or merge_hop_offsets '
        '(merge batches) from the loader\'s batch_size and fanouts')
    for i, conv in enumerate(self.convs()):
      hops_used = self.num_layers - i
      n_in = self.hop_node_offsets[hops_used]
      e_used = self.hop_edge_offsets[hops_used - 1]
      if self.merge_dense:
        x = conv(x[:n_in], edge_index[:, :e_used], edge_mask[:e_used])
      else:
        x = conv(x[:n_in], edge_mask[:e_used])
      if i < self.num_layers - 1:
        x = torch.relu(x)
    return x
