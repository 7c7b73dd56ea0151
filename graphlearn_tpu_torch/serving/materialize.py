"""Offline layer-wise full-graph embedding materialization.

Counterpart of ``graphlearn_tpu/serving/materialize.py``: every node's
layer-``l`` embedding is computed layer by layer, so the online engine
answers lookups from a precomputed table instead of running a sampled
multi-hop forward per request.

- **No sampling.** Each node aggregates over its full neighbour list,
  padded to a static width ``W`` (the max stored degree, or
  ``neighbor_cap``, which truncates heavier nodes) — the
  ``padded_neighbors`` table, built once per graph.
- **Contiguous row blocks.** A layer pass walks the node table in
  ``block_size`` blocks, ``chunk_size`` blocks per chunk; each block's
  forward consumes ``[B + B*W, F]`` rows gathered from the previous
  layer's store (self rows, then neighbour rows, ``prev[max(nbr, 0)]``,
  in one ``ops.gather_rows_hbm`` call: the row-gather kernel on the
  card) and writes ``[B, F_out]`` rows into the next store in place.
  Layer ``l``'s output becomes layer ``l+1``'s input, so the device
  holds two stores at a time (plus ``x0`` and the penultimate store kept
  for the refresh).
- **The same forward.** Each block runs
  ``models.train.make_layer_slice_fn`` — a slice of the model's own
  segment forward — so served and trained models cannot drift.

- **Spill to disk.** With ``spill_dir`` every completed layer pass also
  lands on disk as a memory-mapped ``storage.DiskTier`` (``pass_<layer>``,
  the JAX package's layout), a durable copy of the store version: the
  final table serves beyond the device through
  :meth:`EmbeddingMaterializer.tiered_embedding_store`, and after a
  restart :func:`warm_embedding_store` reopens it without
  rematerializing.

- **Typed graphs (RGNN).** Per node type one store, per stored edge
  type one padded adjacency (keyed by the edge type's key type, padded
  to that type's row count). The passes: a row-local per-type input
  projection (``embed/{t}``); per conv layer, one pass per target type
  over its live edge types (``{layer}/{t}``: those whose result type
  still has a store, HeteroConv's type dropping), each block's rows
  gathered per result type in one row gather (the kernel on the card);
  then the ``lin_out`` head on ``out_ntype`` (``head/{t}``), or the
  per-type stores when the model has no head. ``refresh_rows(ids,
  ntype=)`` reruns the last conv layer (and the head for the output
  type) for a bucket of one type's ids.

Each pass writes one flight record (``metrics.flight``, its ``pass``
label in the record), as a training epoch does.

``dist_embedding_store(mesh)`` serves the final table sharded over a
``distributed.ShardMesh`` (``store.DistEmbeddingStore``).
"""
import os
import re
from typing import Optional

import numpy as np
import torch

from ..metrics import flight
from ..models import train as train_lib
from ..models.models import GAT, GCN, RGNN, GraphSAGE
from ..ops.gather import gather_rows_hbm
from ..typing import reverse_edge_type
from ..utils import resolve_device, strict
from ..utils.trace import record_dispatch
from .store import EmbeddingStore, TieredEmbeddingStore, pow2_cap


def padded_neighbors(topo, neighbor_cap: Optional[int] = None):
  """``[N, W]`` int32 padded full-neighbour table from a stored Topology.

  Row ``v`` holds v's stored neighbour list (out-edges for a CSR graph,
  in-edges for CSC: the grouping the samplers draw from), padded with -1
  to ``W = max degree`` (or ``neighbor_cap``, which truncates heavier
  nodes). Built once per graph on the host.
  """
  indptr = np.asarray(topo.indptr, np.int64)
  indices = np.asarray(topo.indices, np.int64)
  n = indptr.shape[0] - 1
  deg = np.diff(indptr)
  w = int(deg.max()) if neighbor_cap is None else int(neighbor_cap)
  w = max(w, 1)
  nbr = np.full((n, w), -1, np.int32)
  if indices.size:
    key = np.repeat(np.arange(n), deg)
    off = np.arange(indices.shape[0]) - np.repeat(indptr[:-1], deg)
    keep = off < w
    nbr[key[keep], off[keep]] = indices[keep]
  return nbr


def _block_edges(b: int, w: int) -> np.ndarray:
  """The constant ``[2, b*w]`` block-graph COO: each of the block's ``b``
  target slots (rows ``[0, b)``) receives from its ``w`` neighbour slots
  (rows ``[b, b + b*w)``, row-major)."""
  row = b + np.arange(b * w, dtype=np.int32)
  col = np.repeat(np.arange(b, dtype=np.int32), w)
  return np.stack([row, col])


class EmbeddingMaterializer:
  """Layer-wise full-graph embedding program over a Dataset and a model.

  Args:
    dataset: the ``data.Dataset`` to materialize over (homogeneous, or
      typed with per-type features); its device is the materializer's.
    model: on the dataset's device, built without hop offsets or dense
      flags (the segment forward, whose layer slices the blocks run): the
      port's ``GraphSAGE`` or ``GAT`` on a homogeneous dataset, ``RGNN``
      on a typed one. It owns its weights. ``GCN`` is refused: its degree
      norm is a function of the edge_index the conv sees, which block
      subgraphs cannot reproduce.
    block_size: B, rows per block.
    chunk_size: K, blocks per chunk.
    neighbor_cap: optional per-node neighbour truncation (approximate
      serving; None = exact full-neighbour width).
    spill_dir: optional directory every completed pass is written to as
      a disk tier (``spilled`` maps the pass label to its tier).

  ``materialize()`` returns the final table (typed: the head's table of
  ``out_ntype``, or the per-type stores without a head); the store set
  before the last layer stays on the instance for :meth:`refresh_rows`.
  """

  _NAME = 'EmbeddingMaterializer'

  def __init__(self, dataset, model, *, block_size: int = 128,
               chunk_size: int = 8, neighbor_cap: Optional[int] = None,
               spill_dir: Optional[str] = None):
    if block_size < 1 or chunk_size < 1:
      raise ValueError('block_size and chunk_size must be >= 1')
    # the indexed form ('cuda' -> 'cuda:0'), comparable with a tensor's
    self.device = torch.empty(
        0, device=resolve_device(dataset.device)).device
    self.model = model
    self.block_size = int(block_size)
    self.chunk_size = int(chunk_size)
    self.neighbor_cap = neighbor_cap
    self.spill_dir = spill_dir
    self.spilled = {}     # pass label -> storage.DiskTier
    self.is_hetero = bool(dataset.is_hetero)
    self._embeddings = None
    self._penultimate = None
    self._ei = {}         # (target, live edge types, b) -> block COO
    if self.is_hetero:
      self._init_hetero(dataset)
    else:
      self._init_homo(dataset)
    self.num_layers = int(model.num_layers)
    p = next(model.parameters())
    if p.device != self.device:
      raise ValueError(f'the model is on {p.device} and the dataset on '
                       f'{self.device}; put both on one device')

  # ------------------------------------------------------------- setup

  def _n_pad(self, n: int) -> int:
    return -(-n // self.block_size) * self.block_size

  @property
  def n_pad(self) -> int:
    return self._n_pad(self.num_nodes)

  def _pad_rows(self, arr: np.ndarray) -> np.ndarray:
    """Pad a ``[N, ...]`` host table up to the block multiple."""
    n = arr.shape[0]
    n_pad = self._n_pad(n)
    if n_pad == n:
      return arr
    out = np.zeros((n_pad,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    return out

  def _x0_rows(self, feature, n: int) -> torch.Tensor:
    """Id-ordered ``[N_pad, F]`` float32 rows of ``n`` nodes read through
    the port's ``Feature`` on the device (id2index resolved), zero past
    N."""
    rows = feature[torch.arange(n, device=self.device)]
    x0 = torch.zeros((self._n_pad(n), rows.shape[1]), dtype=torch.float32,
                     device=self.device)
    x0[:n] = rows
    return x0

  def _init_homo(self, dataset):
    model = self.model
    if isinstance(model, GCN):
      # GCNConv normalises by the degrees of the edge_index it is given;
      # in a block subgraph every neighbour slot has local out-degree 1,
      # so the norm would part from the full-graph forward's
      raise ValueError(
          'GCN materialization is unsupported: GCNConv normalizes by '
          'degrees of the edge_index it sees, which a block subgraph '
          'cannot reproduce — serve GraphSAGE/GAT (homo) or RGNN '
          '(hetero) models')
    if not isinstance(model, (GraphSAGE, GAT)) or not model.segment:
      raise ValueError(
          f'{type(model).__name__} materialization is unsupported: the '
          'port materializes GraphSAGE or GAT built without hop offsets / '
          'dense flags (the plain segment forward; its layer slices are '
          'what the blocks run)')
    if dataset.node_features is None:
      raise ValueError('materialization needs node features')
    topo = dataset.graph.topo
    self.num_nodes = int(topo.num_nodes)
    nbr = padded_neighbors(topo, self.neighbor_cap)
    self._w = nbr.shape[1]
    nbr = self._pad_rows(nbr)
    # pad rows keep -1 everywhere (zeros would alias node 0)
    nbr[self.num_nodes:] = -1
    self._nbr = torch.as_tensor(nbr).to(self.device)
    self._x0 = self._x0_rows(dataset.node_features, self.num_nodes)

  def _init_hetero(self, dataset):
    model = self.model
    if not isinstance(model, RGNN):
      raise ValueError('hetero materialization covers RGNN models')
    if model.hop_node_offsets is not None or model.tree_dense or \
        model.merge_dense:
      raise ValueError(
          'RGNN materialization runs the plain segment forward (its layer '
          'slices): build the serving model without hop offsets / dense '
          'flags')
    feats = dataset.node_features
    if not isinstance(feats, dict) or not feats:
      raise ValueError('hetero materialization needs per-type features')
    self.edge_dir = dataset.edge_dir
    self._etypes = list(dataset.graph.keys())
    # stored (u, r, v): edge_dir='out' keys by src u (the aggregation's
    # target type) expanding to v neighbours, and the batches key the
    # message-flow edges by reverse_edge_type, the sampler's convention
    self._key_t = {et: (et[0] if self.edge_dir == 'out' else et[2])
                   for et in self._etypes}
    self._res_t = {et: (et[2] if self.edge_dir == 'out' else et[0])
                   for et in self._etypes}
    self._out_et = {et: (reverse_edge_type(et) if self.edge_dir == 'out'
                         else et) for et in self._etypes}
    self.num_nodes = {t: int(f.size) for t, f in feats.items()}
    self._x0 = {t: self._x0_rows(f, self.num_nodes[t])
                for t, f in feats.items()}
    self._nbr, self._w = {}, {}
    for et in self._etypes:
      nbr = padded_neighbors(dataset.graph[et].topo, self.neighbor_cap)
      kt = self._key_t[et]
      n_t = self.num_nodes.get(kt)
      if n_t is None:
        raise ValueError(f'etype {et}: key type {kt!r} has no features')
      if nbr.shape[0] < n_t:   # isolated tail nodes the topo never saw
        nbr = np.concatenate(
            [nbr, np.full((n_t - nbr.shape[0], nbr.shape[1]), -1,
                          np.int32)])
      nbr = self._pad_rows(nbr[:n_t])
      nbr[n_t:] = -1
      self._nbr[et] = torch.as_tensor(nbr).to(self.device)
      self._w[et] = nbr.shape[1]
    # types that ever receive messages; others keep their embed output
    # but never advance (HeteroConv drops non-target types)
    self._targets = {self._key_t[et] for et in self._etypes}

  def _gather_block(self, prev, self_ids, nbr_blk):
    """``(x, edge_mask)`` of one block: ``prev`` rows of ``self_ids``
    then of ``max(nbr_blk, 0)`` row-major, in one row gather (the
    kernel clamps -1 to row 0, the reference's ``prev[max(nbr, 0)]``)."""
    ids = torch.cat([self_ids, nbr_blk.reshape(-1)])
    return gather_rows_hbm(prev, ids), (nbr_blk >= 0).reshape(-1)

  def _block_ei(self, t, live, b: int):
    """The block COO of target type ``t`` over the edge types ``live`` at
    ``b`` self rows (:meth:`_hetero_layout`), on the device, cached."""
    key = (t, live, b)
    if key not in self._ei:
      if t is None:
        ei = _block_edges(b, self._w)
      else:
        _, ei = self._hetero_layout(t, live, b)
      # a one-time upload of a static table: deliberate (JAX's explicit
      # device_put), so a GLT_STRICT pass lets it through
      with strict.explicit():
        self._ei[key] = (torch.as_tensor(ei).to(self.device) if t is None
                         else {oet: torch.as_tensor(v).to(self.device)
                               for oet, v in ei.items()})
    return self._ei[key]

  # ------------------------------------------------------------- passes

  @torch.no_grad()
  def _pass(self, n_pad: int, block_fn, label: str) -> torch.Tensor:
    """One pass over ``n_pad`` rows: ``chunk_size`` blocks per chunk, each
    block's ``[B, F_out]`` rows from ``block_fn(base)`` written into the
    output store in place. Flight-recorded like a training epoch (one
    record per pass, ``pass`` = ``label``), with one ``embed_store_init``
    dispatch and one ``embed_chunk`` dispatch per chunk. Under
    ``GLT_STRICT`` the store init and the chunks are the guarded region
    (``utils.strict``), as in JAX."""
    b = self.block_size
    nblocks = n_pad // b
    out = None
    tok = flight.epoch_begin()
    completed, chunks = False, 0
    try:
      with strict.strict_guards():
        record_dispatch('embed_store_init')
        for start in range(0, nblocks, self.chunk_size):
          record_dispatch('embed_chunk')
          for g in range(start, min(start + self.chunk_size, nblocks)):
            base = g * b
            h = block_fn(base)
            if out is None:
              out = torch.empty((n_pad, h.shape[1]), dtype=h.dtype,
                                device=self.device)
            out[base:base + b] = h
          chunks += 1
      completed = True
    finally:
      flight.end_for(
          self, tok, emitter=self._NAME, steps=nblocks,
          completed=completed, config=self._flight_config(),
          extra={'pass': label, 'chunks': chunks})
    return out

  def _flight_config(self) -> dict:
    return dict(emitter=self._NAME, block_size=self.block_size,
                chunk_size=self.chunk_size, hetero=self.is_hetero,
                num_layers=self.num_layers,
                neighbor_cap=self.neighbor_cap)

  def _layer_pass(self, layer: int, prev: torch.Tensor) -> torch.Tensor:
    """One homogeneous layer over every block."""
    b = self.block_size
    slice_fn = train_lib.make_layer_slice_fn(self.model, layer, layer + 1)
    ei = self._block_ei(None, (), b)

    def block(base):
      self_ids = torch.arange(base, base + b, dtype=torch.int32,
                              device=self.device)
      x, em = self._gather_block(prev, self_ids, self._nbr[base:base + b])
      return slice_fn(dict(x=x, edge_index=ei, edge_mask=em))[:b]

    return self._pass(self.n_pad, block, str(layer))

  def _hetero_layout(self, t, live_ets, b: Optional[int] = None):
    """The block layout of target type ``t`` over the edge types
    ``live_ets``: ``t``'s self rows lead its buffer, and each edge type's
    ``B*W`` neighbour rows are appended to its result type's buffer in
    edge-type order. Returns ``(offsets by edge type, {emitted edge type:
    [2, B*W] COO})``; ``b`` defaults to the block size (a refresh bucket
    passes its capacity: the same layout at its scale)."""
    # graftlint: allow[host-sync] b is a Python int (the block size or a refresh bucket's capacity), never a tensor
    b = self.block_size if b is None else int(b)
    widths = {t: b}
    offsets = {}
    for et in live_ets:
      r = self._res_t[et]
      offsets[et] = widths.get(r, 0)
      widths[r] = offsets[et] + b * self._w[et]
    ei = {}
    for et in live_ets:
      w = self._w[et]
      row = offsets[et] + np.arange(b * w, dtype=np.int32)
      col = np.repeat(np.arange(b, dtype=np.int32), w)
      ei[self._out_et[et]] = np.stack([row, col])
    return offsets, ei

  def _hetero_block(self, stores, t, live, self_ids, nbr_blks):
    """The typed batch dict of one block of target type ``t``: per result
    type one row gather of its store (``t``'s self rows first, then each
    live edge type's neighbour rows in edge-type order), the edge masks
    and the cached block COO."""
    ids = {t: [self_ids]}
    masks = {}
    for et in live:
      blk = nbr_blks[et]
      masks[self._out_et[et]] = (blk >= 0).reshape(-1)
      ids.setdefault(self._res_t[et], []).append(blk.reshape(-1))
    x = {r: gather_rows_hbm(stores[r], torch.cat(v) if len(v) > 1 else v[0])
         for r, v in ids.items()}
    return dict(x=x, edge_index=self._block_ei(t, live, self_ids.shape[0]),
                edge_mask=masks)

  def _rowlocal_pass(self, t, src, fn, label: str) -> torch.Tensor:
    """A row-local pass (the per-type input projection, the head): each
    block's slice of ``src`` through ``fn``."""
    b = self.block_size

    def block(base):
      h = fn(dict(x={t: src[base:base + b]}, edge_index={}, edge_mask={}))
      return h[t] if isinstance(h, dict) else h

    return self._pass(src.shape[0], block, label)

  def _hetero_live_for(self, t, stores=None):
    """The edge types feeding target type ``t`` in a conv layer over the
    store set ``stores`` (default: the one before the last layer, the
    refresh's): key type ``t`` and a result type with a store."""
    stores = self._penultimate if stores is None else stores
    return tuple(et for et in self._etypes
                 if self._key_t[et] == t and self._res_t[et] in stores)

  def _materialize_hetero(self):
    b = self.block_size
    model = self.model
    embed_fn = train_lib.make_layer_slice_fn(model, 0, 0, embed=True,
                                             head=False)
    stores = {}
    for t, x0 in self._x0.items():
      stores[t] = self._rowlocal_pass(t, x0, embed_fn, f'embed/{t}')
      self._spill_pass(f'embed/{t}', stores[t])
    for layer in range(self.num_layers):
      slice_fn = train_lib.make_layer_slice_fn(
          model, layer, layer + 1, embed=False, head=False)
      new_stores = {}
      for t in sorted(self._targets):
        if t not in stores:
          continue
        live = self._hetero_live_for(t, stores)
        if not live:
          continue

        def block(base, t=t, live=live, prev=stores):
          self_ids = torch.arange(base, base + b, dtype=torch.int32,
                                  device=self.device)
          nbrs = {et: self._nbr[et][base:base + b] for et in live}
          return slice_fn(self._hetero_block(prev, t, live, self_ids,
                                             nbrs))[t][:b]

        new_stores[t] = self._pass(stores[t].shape[0], block,
                                   f'{layer}/{t}')
        self._spill_pass(f'{layer}/{t}', new_stores[t])
      if layer == self.num_layers - 1:
        self._penultimate = stores
      stores = new_stores
    self.stores = stores
    out_t = model.out_ntype
    if out_t is None:
      self._embeddings = stores
      return stores
    if out_t not in stores:
      raise ValueError(f'out_ntype {out_t!r} received no messages')
    head_fn = train_lib.make_layer_slice_fn(
        model, self.num_layers, self.num_layers, embed=False, head=True)
    self._embeddings = self._rowlocal_pass(out_t, stores[out_t], head_fn,
                                           f'head/{out_t}')
    self._spill_pass(f'head/{out_t}', self._embeddings)
    return self._embeddings

  @torch.no_grad()
  def materialize(self):
    """Run the full layer-by-layer pass. Returns the final table on the
    device (``[N_pad, out_dim]``; typed: the head's table of
    ``out_ntype``, or the per-type store dict without a head); rows past
    the node count are block padding, never served."""
    if self.is_hetero:
      return self._materialize_hetero()
    prev = self._x0
    for layer in range(self.num_layers):
      if layer == self.num_layers - 1:
        self._penultimate = prev
      prev = self._layer_pass(layer, prev)
      self._spill_pass(str(layer), prev)
    self._embeddings = prev
    return prev

  def _spill_pass(self, label: str, out: torch.Tensor):
    """Write a completed pass's output store to its disk tier (with
    ``spill_dir``)."""
    if self.spill_dir is None:
      return
    from ..storage.disk import spill_array
    safe = label.replace('/', '_').replace(' ', '_')
    self.spilled[label] = spill_array(
        os.path.join(self.spill_dir, f'pass_{safe}'), out.cpu().numpy())

  @property
  def embeddings(self):
    if self._embeddings is None:
      raise RuntimeError('call materialize() first')
    return self._embeddings

  def embedding_store(self) -> EmbeddingStore:
    """The materialized table as a serving ``EmbeddingStore`` with the
    real node count, so block padding stays behind the engine's id
    validation. The store writes refreshes into this same table
    (homogeneous only: typed stores are per type)."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] per-type outputs by design
      raise ValueError('hetero materialization produces per-type '
                       'stores — wrap the one you serve explicitly: '
                       'EmbeddingStore(table, num_nodes=N_type)')
    return EmbeddingStore(self.embeddings, num_nodes=self.num_nodes)

  def tiered_embedding_store(self, hot_rows: int = 0, warm_rows: int = 0,
                             **kwargs) -> TieredEmbeddingStore:
    """The spilled final-layer table as a ``TieredEmbeddingStore``:
    ``hot_rows`` on the device, ``warm_rows`` in host RAM, the rest served
    from the memory-mapped spill (needs ``spill_dir``; homogeneous only).
    ``kwargs`` go to ``storage.TieredFeature`` (its device defaults to
    the materializer's)."""
    from ..storage.tiered import TieredFeature
    if self.is_hetero:
      # graftlint: allow[hetero-gate] per-type outputs by design
      raise ValueError('hetero materialization produces per-type '
                       'stores — build TieredEmbeddingStore over the '
                       'spilled pass tier you serve explicitly')
    if self.spill_dir is None:
      raise ValueError('tiered_embedding_store needs '
                       'EmbeddingMaterializer(..., spill_dir=...)')
    if self._embeddings is None:
      raise RuntimeError('call materialize() first')
    kwargs.setdefault('device', self.device)
    tier = self.spilled[str(self.num_layers - 1)]
    tf = TieredFeature(tier, hot_rows=hot_rows, warm_rows=warm_rows,
                       **kwargs)
    return TieredEmbeddingStore(tf, num_nodes=self.num_nodes)

  def dist_embedding_store(self, mesh, **kwargs):
    """The materialized table as a sharded ``DistEmbeddingStore`` over
    ``mesh``, with the real node count passed (block-pad rows must not
    become servable ids). ``kwargs`` go to ``DistEmbeddingStore.build``
    (split_ratio / cache_rows / hotness / wire_dtype / bucket_frac)."""
    from .store import DistEmbeddingStore
    if self.is_hetero:
      # graftlint: allow[hetero-gate] per-type outputs by design
      raise ValueError('hetero materialization produces per-type '
                       'stores — build the one you serve explicitly '
                       'with DistEmbeddingStore.build(table, mesh, '
                       'num_nodes=N_type, ...)')
    if self._embeddings is None:
      raise RuntimeError('call materialize() first')
    return DistEmbeddingStore.build(self._embeddings, mesh,
                                    num_nodes=self.num_nodes, **kwargs)

  # ------------------------------------------------------------ refresh

  def _refresh_out_dim(self, ntype=None) -> int:
    if not self.is_hetero or self.model.out_ntype == ntype:
      return int(self.model.out_dim)
    return int(self.stores[ntype].shape[1])

  def _hetero_refresh(self, t, ids_t, mask):
    """The last conv layer for a bucket of type ``t`` (``ids_t`` -1
    padded, ``mask`` its valid slots) over the store set before it, in
    the materializer's layout at the bucket's scale, then the head when
    ``t`` is the output type."""
    live = self._hetero_live_for(t)
    if not live:
      raise ValueError(f'type {t!r} receives no messages in the last '
                       'layer — nothing to refresh')
    last = self.num_layers - 1
    model = self.model
    safe = torch.clamp(ids_t, min=0)
    nbrs = {et: torch.where(mask[:, None],
                            self._nbr[et][safe.to(torch.int64)], -1)
            for et in live}
    slice_fn = train_lib.make_layer_slice_fn(model, last, last + 1,
                                             embed=False, head=False)
    h = slice_fn(self._hetero_block(self._penultimate, t, live, safe,
                                    nbrs))[t]
    if model.out_ntype == t:
      head_fn = train_lib.make_layer_slice_fn(
          model, self.num_layers, self.num_layers, embed=False, head=True)
      h = head_fn(dict(x={t: h}, edge_index={}, edge_mask={}))
    return h

  @torch.no_grad()
  def refresh_rows(self, ids, ntype=None) -> np.ndarray:
    """Final-layer-only refresh: recompute the last-layer rows of ``ids``
    from the store before the last layer and their full neighbour rows,
    in a ``pow2_cap`` bucket (the engine's stale-node hook). Returns
    ``[len(ids), F_out]`` host rows.

    Typed (RGNN): pass ``ntype``; the rows go through that type's last
    conv layer (and the head when it is the output type), over the same
    per-edge-type neighbour tables the offline pass read. Wire it into an
    engine as ``refresh_fn=lambda ids: mat.refresh_rows(ids,
    ntype='paper')``."""
    if self._penultimate is None:
      raise RuntimeError('call materialize() first')
    if self.is_hetero:
      if ntype is None:
        raise ValueError(
            'hetero refresh needs the node type: '
            "refresh_rows(ids, ntype='paper') (per-type stores, "
            'docs/serving.md)')
      if ntype not in getattr(self, 'stores', {}):
        raise ValueError(f'{ntype!r} has no final-layer store '
                         f'(have: {sorted(self.stores)})')
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size == 0:
      return np.zeros((0, self._refresh_out_dim(ntype)), np.float32)
    cap = pow2_cap(ids.size)
    padded = np.full((cap,), -1, np.int32)
    padded[:ids.size] = ids
    record_dispatch('serve_refresh')
    ids_t = torch.as_tensor(padded).to(self.device)
    mask = ids_t >= 0
    if self.is_hetero:
      h = self._hetero_refresh(ntype, ids_t, mask)
    else:
      safe = torch.clamp(ids_t, min=0)
      nbr_blk = torch.where(mask[:, None], self._nbr[safe.to(torch.int64)],
                            -1)
      x, em = self._gather_block(self._penultimate, safe, nbr_blk)
      last = self.num_layers - 1
      slice_fn = train_lib.make_layer_slice_fn(self.model, last, last + 1)
      h = slice_fn(dict(x=x, edge_index=self._block_ei(None, (), cap),
                        edge_mask=em))
    return h[:ids.size].cpu().numpy()


def warm_embedding_store(spill_dir: str, num_nodes: int, *,
                         hot_rows: Optional[int] = None,
                         warm_rows: int = 0,
                         pass_label: Optional[str] = None, device=None):
  """The serving restart path: a store rebuilt from the spilled
  final-layer tier on disk, without rematerializing.

  Args:
    spill_dir: the materializer's spill directory (either package's).
    num_nodes: the real node count (the spilled table carries block-pad
      rows, which must stay behind the engine's id validation).
    hot_rows: None loads the whole table to the device (an
      ``EmbeddingStore``); otherwise a ``TieredEmbeddingStore`` with this
      hot prefix and ``warm_rows`` in host RAM.
    pass_label: the spilled pass to serve (default: the highest-numbered
      ``pass_<n>``, the final layer).
    device: the store's device (None means the card).
  """
  from ..storage.disk import DiskTier
  from ..storage.tiered import TieredFeature
  if pass_label is None:
    passes = sorted(
        int(m.group(1)) for m in
        (re.match(r'^pass_(\d+)$', d) for d in os.listdir(spill_dir)) if m)
    if not passes:
      spilled = sorted(d for d in os.listdir(spill_dir)
                       if d.startswith('pass_'))
      raise FileNotFoundError(
          f'no numeric pass_<n> tier under {spill_dir!r} '
          f'(found: {spilled or "nothing"}): the materializer ran without '
          'spill_dir, or the spill holds per-type labels; pass the '
          'pass_label of the store to serve')
    pass_label = str(passes[-1])
  safe = str(pass_label).replace('/', '_').replace(' ', '_')
  tier = DiskTier(os.path.join(spill_dir, f'pass_{safe}'))
  if num_nodes > tier.shape[0]:
    raise ValueError(f'num_nodes={num_nodes} exceeds the spilled table '
                     f'height {tier.shape[0]}')
  if hot_rows is None:
    table = tier.gather(np.arange(tier.shape[0], dtype=np.int64))
    return EmbeddingStore(table, num_nodes=num_nodes, device=device)
  tf = TieredFeature(tier, hot_rows=hot_rows, warm_rows=warm_rows,
                     device=device)
  return TieredEmbeddingStore(tf, num_nodes=num_nodes)
