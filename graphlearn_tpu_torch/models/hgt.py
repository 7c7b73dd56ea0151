"""Heterogeneous Graph Transformer (HGT): the typed attention conv and
its stack.

Counterpart of ``graphlearn_tpu/models/hgt.py``:

- per node type the projections ``k_{t}`` / ``q_{t}`` / ``v_{t}``, the
  output projection ``a_{t}`` and the gated residual ``skip_{t}`` (the
  key projection's bias gets a gradient of exactly 0: the softmax
  cancels it, see ``_keys``);
- per edge type (message direction ``(src, rel, dst)``) the relation
  matrices ``att_*`` / ``msg_*`` (``[H, D, D]``, applied by
  ``einsum('nhd,hde->nhe')``) and the prior ``pri_*`` (``[H]``);
- attention is a softmax over each destination's incoming edges of one
  edge type, the relation outputs summed at the destination, then
  ``a_{t}(gelu(agg))`` (flax's GELU, the tanh form) and, where the input
  is ``out_dim`` wide, the sigmoid-gated skip.

Logits and softmax run in float32 under any compute ``dtype``. Flax
creates every metadata type's parameters whether or not a batch holds
the type, so ``__init__`` builds them all: an absent type's
``k/q/v`` take ``in_dims[t]`` (default ``out_dim``) inputs.

``tree_records`` (``sampler.hetero_tree_blocks``, restricted to the
layer's hops) replaces the segment softmax with a masked k-run softmax
over the typed tree layout (a parent's in-edges per edge type are its
contiguous run), and with ``merge=True`` over calibrated merge records
(children gathered through the edge rows, each run block ADDED at the
base ``min(tgt - j)`` the device computes, ``TreeHeteroConv._acc_add``).
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import resolve_device
from .conv import dense, segment_softmax_max
from .models import (TreeHeteroConv, _dynamic_rows, check_hetero_offsets,
                     draw_parameters, hetero_trim, resolve_hetero_parts,
                     walk_hetero_records)


def _etype_name(et) -> str:
  return '__'.join(et)


def _keys(lin, x, dtype):
  """``k_{t}(x)`` (flax's ``Dense``) whose bias gets a gradient of exactly
  0. The bias shifts every logit of one destination and edge type by the
  same ``q . (b A)``, which the softmax takes out, so its exact gradient
  is 0; computed (as JAX does), it is rounding noise, which Adam scales
  up to a step of the rate. A zero gradient, not None, keeps the bias in
  Adam's state at every step: from zero moments it stays put, and from
  optax's moments it decays as optax's would. The forward's value is the
  Dense's."""
  dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
  bias = lin.bias.detach() + lin.bias * 0
  return torch.matmul(x.to(dt), lin.weight.to(dt).t()) + bias.to(dt)


class HGTConv(nn.Module):
  """One HGT layer over padded typed batches
  (``graphlearn_tpu/models/hgt.py:HGTConv``).

  ``metadata`` = ``(node_types, edge_types)`` in message-flow orientation
  (the batch's keys). ``in_dims``: per-type input widths (default
  ``out_dim``, every conv input inside ``HGT``). ``tree_records`` /
  ``out_rows`` / ``merge``: the dense k-run forwards and their per-type
  output prefixes (see the module docstring).
  """

  def __init__(self, out_dim: int, metadata, heads: int = 4, dtype=None,
               in_dims=None, tree_records=None, out_rows=None,
               merge: bool = False):
    super().__init__()
    assert out_dim % heads == 0, \
        f'heads ({heads}) must divide out_dim ({out_dim})'
    ntypes, etypes = metadata
    self.out_dim, self.heads, self.dtype = out_dim, heads, dtype
    self.ntypes = list(ntypes)
    self.etypes = [tuple(et) for et in etypes]
    self.tree_records = tree_records
    self.out_rows = out_rows
    self.merge = merge
    d = out_dim // heads
    for t in self.ntypes:
      w = (in_dims or {}).get(t, out_dim)
      for proj in ('k', 'q', 'v'):
        self.add_module(f'{proj}_{t}', nn.Linear(w, out_dim))
    for et in self.etypes:
      name = _etype_name(et)
      for kind in ('att', 'msg'):
        self.register_parameter(f'{kind}_{name}',
                                nn.Parameter(torch.empty(heads, d, d)))
      self.register_parameter(f'pri_{name}', nn.Parameter(torch.ones(heads)))
    for t in self.ntypes:
      self.add_module(f'a_{t}', nn.Linear(out_dim, out_dim))
      self.register_parameter(f'skip_{t}', nn.Parameter(torch.ones(())))
    draw_parameters(self)

  def forward(self, x_dict, edge_index_dict, edge_mask_dict):
    heads, d = self.heads, self.out_dim // self.heads
    k, q, v = {}, {}, {}
    for t in self.ntypes:
      if t not in x_dict:
        continue
      x = x_dict[t]
      if self.dtype is not None:
        x = x.to(self.dtype)
      n = x.shape[0]
      k[t] = _keys(getattr(self, f'k_{t}'), x, self.dtype)
      q[t] = dense(getattr(self, f'q_{t}'), x, self.dtype)
      v[t] = dense(getattr(self, f'v_{t}'), x, self.dtype)
      k[t], q[t], v[t] = (h.reshape(n, heads, d) for h in (k[t], q[t], v[t]))
    cdtype = self.dtype
    if cdtype is None:
      cdtype = x_dict[next(iter(x_dict))].dtype
      for x in x_dict.values():
        cdtype = torch.promote_types(cdtype, x.dtype)
    dense_mode = self.tree_records is not None
    rows_out = {t: (k[t].shape[0] if self.out_rows is None
                    else min(int(self.out_rows[t]), k[t].shape[0]))
                for t in k}
    agg = {t: k[t].new_zeros((rows_out[t] if dense_mode else k[t].shape[0],
                              heads, d), dtype=cdtype) for t in k}
    for et in self.etypes:
      src_t, _, dst_t = et
      name = _etype_name(et)
      if et not in edge_index_dict or src_t not in k or dst_t not in k:
        continue
      a_rel = getattr(self, f'att_{name}')
      m_rel = getattr(self, f'msg_{name}')
      p_rel = getattr(self, f'pri_{name}')
      k_rel = torch.einsum('nhd,hde->nhe', k[src_t], a_rel.to(k[src_t].dtype))
      v_rel = torch.einsum('nhd,hde->nhe', v[src_t], m_rel.to(v[src_t].dtype))
      if dense_mode:
        fn = self._merge_et if self.merge else self._dense_et
        agg[dst_t] = agg[dst_t] + fn(
            et, k_rel, v_rel, q[dst_t], p_rel, edge_index_dict,
            edge_mask_dict, rows_out[dst_t], cdtype)
        continue
      agg[dst_t] = agg[dst_t] + self._segment_et(
          k_rel, v_rel, q[dst_t], p_rel, edge_index_dict[et],
          edge_mask_dict[et])
    out = {}
    for t in self.ntypes:
      if t not in k:
        continue
      n = agg[t].shape[0]
      a = dense(getattr(self, f'a_{t}'),
                F.gelu(agg[t].reshape(n, self.out_dim), approximate='tanh'),
                self.dtype)
      if x_dict[t].shape[-1] == self.out_dim:
        gate = torch.sigmoid(getattr(self, f'skip_{t}')).to(a.dtype)
        out[t] = gate * a + (1.0 - gate) * x_dict[t][:n].to(a.dtype)
      else:
        out[t] = a
    return out

  def _segment_et(self, k_rel, v_rel, q_dst, p_rel, ei, em):
    """One edge type's attention as a segment softmax over each
    destination's valid in-edges (``n_dst + 1`` segments, the last for
    the invalid edges), ``[n_dst, H, D]``."""
    d = k_rel.shape[-1]
    row = torch.clamp(ei[0], min=0).to(torch.int64)
    col = torch.clamp(ei[1], min=0).to(torch.int64)
    valid = em & (ei[0] >= 0) & (ei[1] >= 0)
    n_dst = q_dst.shape[0]
    logits = (q_dst.index_select(0, col).float() *
              k_rel.index_select(0, row).float()).sum(-1)
    logits = logits * p_rel[None, :] / math.sqrt(d)           # [E, H]
    tgt = torch.where(valid, col, n_dst)
    ex = torch.exp(logits - segment_softmax_max(logits, tgt,
                                                n_dst + 1)[tgt])
    ex = torch.where(valid[:, None], ex, 0.0)
    denom = ex.new_zeros((n_dst + 1, ex.shape[1])).index_add_(0, tgt, ex)
    attn = (ex / torch.clamp(denom[tgt], min=1e-9)).to(v_rel.dtype)
    msgs = v_rel.index_select(0, row) * attn[:, :, None]      # [E, H, D]
    msgs = torch.where(valid[:, None, None], msgs,
                       torch.zeros((), dtype=msgs.dtype, device=msgs.device))
    return msgs.new_zeros((n_dst + 1,) + msgs.shape[1:]).index_add_(
        0, tgt, msgs)[:n_dst]

  @staticmethod
  def _run_attention(kc, vc, qp, m, p_rel, d, cdtype):
    """Masked k-run typed attention of the tree and merge forwards:
    ``[f, k, H, D]`` keys and values against ``[f, H, D]`` parent queries
    -> ``[f, H, D]`` (float32 logits; an all-masked run is shifted by 0
    and gives 0)."""
    logits = (qp[:, None].float() * kc.float()).sum(-1)
    logits = logits * p_rel[None, None, :] / math.sqrt(d)     # [f, k, H]
    logits = torch.where(m[..., None], logits, float('-inf'))
    mx = logits.amax(1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(m[..., None], torch.exp(logits - mx), 0.0)
    denom = torch.clamp(ex.sum(1, keepdim=True), min=1e-9)
    attn = (ex / denom).to(cdtype)
    return (vc * attn[..., None]).sum(1)                      # [f, H, D]

  def _et_records(self, et):
    return [r for hop in self.tree_records for r in hop
            if r['out_et'] == tuple(et)]

  def _dense_et(self, et, k_rel, v_rel, q_dst, p_rel, edge_index_dict,
                edge_mask_dict, r_out, cdtype):
    """One edge type over tree records: each parent's in-edges are its
    contiguous k-run, so children are slices."""
    heads, d = self.heads, self.out_dim // self.heads

    def per_record(r, m):
      f, kk, cb, pb = r['fcap'], r['k'], r['child_base'], r['parent_base']
      kc = k_rel[cb:cb + f * kk].reshape(f, kk, heads, d)
      vc = v_rel[cb:cb + f * kk].reshape(f, kk, heads, d)
      return self._run_attention(kc, vc, q_dst[pb:pb + f], m, p_rel, d,
                                 cdtype)

    parts = walk_hetero_records(self._et_records(et), edge_mask_dict, r_out,
                                per_record)
    return resolve_hetero_parts(parts, (heads, d), cdtype, k_rel.device)

  def _merge_et(self, et, k_rel, v_rel, q_dst, p_rel, edge_index_dict,
                edge_mask_dict, r_out, cdtype):
    """One edge type over calibrated merge records: children gathered
    through the edge rows (flat 2D gathers, then reshaped), parent queries
    read at the clamped dynamic base, run blocks added there (the base
    never leaves the device)."""
    heads, d = self.heads, self.out_dim // self.heads
    acc = k_rel.new_zeros((r_out, heads, d), dtype=cdtype)
    kf = k_rel.reshape(-1, heads * d)
    vf = v_rel.reshape(-1, heads * d)
    for r in self._et_records(et):
      if r['parent_base'] >= r_out:
        break
      f, kk = r['fcap'], r['k']
      m, src, base, ok = TreeHeteroConv._run_layout(
          r, edge_mask_dict, edge_index_dict, r_out)
      kc = kf.index_select(0, src).reshape(f, kk, heads, d)
      vc = vf.index_select(0, src).reshape(f, kk, heads, d)
      qp = q_dst.index_select(0, _dynamic_rows(q_dst.shape[0], base, f))
      vals = self._run_attention(kc, vc, qp, m, p_rel, d, cdtype)
      vals = torch.where(ok[:, None, None], vals,
                         torch.zeros((), dtype=vals.dtype,
                                     device=vals.device))
      acc = TreeHeteroConv._acc_add(acc, vals, base)
    return acc


class HGT(nn.Module):
  """HGT stack (``graphlearn_tpu/models/hgt.py:HGT``): per-type input
  projection ``lin_{t}`` + ReLU, ``num_layers`` ``HGTConv`` layers of
  width ``hidden_dim``, and the shared linear ``head`` on ``out_ntype``
  (None: on every type, a dict).

  Args:
    ntypes / etypes: the metadata (message-flow edge types, the batch's
      keys).
    hidden_dim / out_dim / heads / num_layers / out_ntype / dtype: as in
      JAX (``dtype`` the compute dtype; the parameters stay float32).
    hop_node_offsets / hop_edge_offsets: the typed layout
      (``sampler.hetero_tree_layout`` / ``hetero_tree_blocks`` with the
      loader's seed caps and fanouts): the hierarchical forward, each
      layer over the typed prefixes its depth needs.
    tree_records: ``hetero_tree_blocks``'s records: the dense k-run
      attention per layer (needs the offsets); ``merge_dense`` says they
      came from a calibrated merge layout (``etype_caps``).
    in_dims: ``{node type: raw feature width}``. Required: torch builds
      every ``lin_{t}`` at init (flax builds those of the types it
      sees).
    device: None means the card. Weights are drawn on the CPU from
      ``generator`` (``draw_parameters``) and then moved.
  """

  def __init__(self, ntypes, etypes, hidden_dim: int, out_dim: int,
               heads: int = 4, num_layers: int = 2, out_ntype=None,
               dtype=None, hop_node_offsets=None, hop_edge_offsets=None,
               tree_records=None, merge_dense: bool = False, in_dims=None,
               device=None, generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    if not in_dims:
      raise ValueError('HGT needs in_dims={node type: feature width}: '
                       'torch builds each lin_{t} at init')
    if tree_records is not None:
      assert hop_node_offsets is not None, (
          'HGT(tree_records=...) requires the hierarchical hop offsets '
          'built from the same plan')
    self.ntypes = tuple(ntypes)
    self.etypes = tuple(tuple(e) for e in etypes)
    self.hidden_dim, self.out_dim, self.heads = hidden_dim, out_dim, heads
    self.num_layers, self.out_ntype, self.dtype = num_layers, out_ntype, dtype
    self.hop_node_offsets = hop_node_offsets
    self.hop_edge_offsets = (None if hop_edge_offsets is None else
                             {tuple(k): v
                              for k, v in hop_edge_offsets.items()})
    self.tree_records, self.merge_dense = tree_records, merge_dense
    for t, f in in_dims.items():
      self.add_module(f'lin_{t}', nn.Linear(f, hidden_dim))
    meta = (self.ntypes, self.etypes)
    for i in range(num_layers):
      hops_used = num_layers - i
      recs = out_rows = None
      if tree_records is not None:
        recs = tree_records[:hops_used]
        out_rows = {t: o[hops_used - 1] for t, o in hop_node_offsets.items()}
      self.add_module(f'conv{i}', HGTConv(
          hidden_dim, meta, heads=heads, dtype=dtype, tree_records=recs,
          out_rows=out_rows, merge=merge_dense))
    self.head = nn.Linear(hidden_dim, out_dim)
    draw_parameters(self, generator)
    self.to(device)

  def forward(self, x_dict, edge_index_dict, edge_mask_dict):
    hier = self.hop_node_offsets is not None
    if hier:
      check_hetero_offsets(x_dict, edge_index_dict, self.hop_node_offsets,
                           self.hop_edge_offsets, self.num_layers)
    x_dict = {t: torch.relu(dense(getattr(self, f'lin_{t}'), x, self.dtype))
              for t, x in x_dict.items()}
    for i in range(self.num_layers):
      if hier:
        x_in, ei, em = hetero_trim(x_dict, edge_index_dict, edge_mask_dict,
                                   self.hop_node_offsets,
                                   self.hop_edge_offsets,
                                   self.num_layers - i)
      else:
        x_in, ei, em = x_dict, edge_index_dict, edge_mask_dict
      x_dict = getattr(self, f'conv{i}')(x_in, ei, em)
    if self.out_ntype is None:
      return {t: dense(self.head, x, self.dtype) for t, x in x_dict.items()}
    return dense(self.head, x_dict[self.out_ntype], self.dtype)
