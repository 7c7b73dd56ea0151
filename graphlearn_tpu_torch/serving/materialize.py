"""Offline layer-wise full-graph embedding materialization (homogeneous).

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

The heterogeneous passes and the distributed store come with later
slices.
"""
import os
import re
from typing import Optional

import numpy as np
import torch

from ..models import train as train_lib
from ..models.models import GAT, GCN, GraphSAGE
from ..ops.gather import gather_rows_hbm
from ..utils import resolve_device
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
    dataset: the homogeneous ``data.Dataset`` to materialize over; its
      device is the materializer's.
    model: the port's ``GraphSAGE`` or ``GAT`` built without hop offsets
      or dense flags (the segment forward), on the dataset's device. It
      owns its weights. ``GCN`` is refused: its degree norm is a function
      of the edge_index the conv sees, which block subgraphs cannot
      reproduce.
    block_size: B, rows per block.
    chunk_size: K, blocks per chunk.
    neighbor_cap: optional per-node neighbour truncation (approximate
      serving; None = exact full-neighbour width).
    spill_dir: optional directory every completed layer pass is written
      to as a disk tier (``spilled`` maps the pass label to its tier).

  ``materialize()`` returns the final-layer table; the penultimate store
  stays on the instance for :meth:`refresh_rows`.
  """

  def __init__(self, dataset, model, *, block_size: int = 128,
               chunk_size: int = 8, neighbor_cap: Optional[int] = None,
               spill_dir: Optional[str] = None):
    if block_size < 1 or chunk_size < 1:
      raise ValueError('block_size and chunk_size must be >= 1')
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
    # the indexed form ('cuda' -> 'cuda:0'), comparable with a tensor's
    self.device = torch.empty(
        0, device=resolve_device(dataset.device)).device
    p = next(model.parameters())
    if p.device != self.device:
      raise ValueError(f'the model is on {p.device} and the dataset on '
                       f'{self.device}; put both on one device')
    self.model = model
    self.block_size = int(block_size)
    self.chunk_size = int(chunk_size)
    self.neighbor_cap = neighbor_cap
    self.spill_dir = spill_dir
    self.spilled = {}     # pass label -> storage.DiskTier
    self.num_layers = int(model.num_layers)
    self._embeddings = None
    self._penultimate = None
    self._refresh_ei = {}
    topo = dataset.graph.topo
    self.num_nodes = int(topo.num_nodes)
    nbr = padded_neighbors(topo, self.neighbor_cap)
    self._w = nbr.shape[1]
    nbr = self._pad_rows(nbr)
    # pad rows keep -1 everywhere (zeros would alias node 0)
    nbr[self.num_nodes:] = -1
    self._nbr = torch.as_tensor(nbr).to(self.device)
    self._x0 = self._x0_rows(dataset.node_features)
    self._ei = torch.as_tensor(_block_edges(self.block_size, self._w)).to(
        self.device)

  # ------------------------------------------------------------- setup

  @property
  def n_pad(self) -> int:
    return -(-self.num_nodes // self.block_size) * self.block_size

  def _pad_rows(self, arr: np.ndarray) -> np.ndarray:
    """Pad a ``[N, ...]`` host table up to the block multiple."""
    n = arr.shape[0]
    if self.n_pad == n:
      return arr
    out = np.zeros((self.n_pad,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    return out

  def _x0_rows(self, feature) -> torch.Tensor:
    """Id-ordered ``[N_pad, F]`` float32 rows read through the port's
    ``Feature`` on the device (id2index resolved), zero past N."""
    n = self.num_nodes
    rows = feature[torch.arange(n, device=self.device)]
    x0 = torch.zeros((self.n_pad, rows.shape[1]), dtype=torch.float32,
                     device=self.device)
    x0[:n] = rows
    return x0

  def _gather_block(self, prev, self_ids, nbr_blk):
    """``(x, edge_mask)`` of one block: ``prev`` rows of ``self_ids``
    then of ``max(nbr_blk, 0)`` row-major, in one row gather (the
    kernel clamps -1 to row 0, the reference's ``prev[max(nbr, 0)]``)."""
    ids = torch.cat([self_ids, nbr_blk.reshape(-1)])
    return gather_rows_hbm(prev, ids), (nbr_blk >= 0).reshape(-1)

  # ------------------------------------------------------------- passes

  @torch.no_grad()
  def _layer_pass(self, layer: int, prev: torch.Tensor) -> torch.Tensor:
    """One layer over every block: ``chunk_size`` blocks per chunk, each
    block's rows written into the output store in place."""
    b = self.block_size
    slice_fn = train_lib.make_layer_slice_fn(self.model, layer, layer + 1)
    nblocks = self.n_pad // b
    out = None
    for start in range(0, nblocks, self.chunk_size):
      for g in range(start, min(start + self.chunk_size, nblocks)):
        base = g * b
        self_ids = torch.arange(base, base + b, dtype=torch.int32,
                                device=self.device)
        x, em = self._gather_block(prev, self_ids,
                                   self._nbr[base:base + b])
        h = slice_fn(dict(x=x, edge_index=self._ei, edge_mask=em))[:b]
        if out is None:
          out = torch.empty((self.n_pad, h.shape[1]), dtype=h.dtype,
                            device=self.device)
        out[base:base + b] = h
    return out

  @torch.no_grad()
  def materialize(self) -> torch.Tensor:
    """Run the full layer-by-layer pass. Returns the final ``[N_pad,
    out_dim]`` table on the device; rows past ``num_nodes`` are block
    padding, never served."""
    prev = self._x0
    for layer in range(self.num_layers):
      if layer == self.num_layers - 1:
        self._penultimate = prev
      prev = self._layer_pass(layer, prev)
      if self.spill_dir is not None:
        self._spill_pass(str(layer), prev)
    self._embeddings = prev
    return prev

  def _spill_pass(self, label: str, out: torch.Tensor):
    """Write a completed pass's output store to its disk tier."""
    from ..storage.disk import spill_array
    safe = label.replace('/', '_').replace(' ', '_')
    self.spilled[label] = spill_array(
        os.path.join(self.spill_dir, f'pass_{safe}'), out.cpu().numpy())

  @property
  def embeddings(self) -> torch.Tensor:
    if self._embeddings is None:
      raise RuntimeError('call materialize() first')
    return self._embeddings

  def embedding_store(self) -> EmbeddingStore:
    """The materialized table as a serving ``EmbeddingStore`` with the
    real node count, so block padding stays behind the engine's id
    validation. The store writes refreshes into this same table."""
    return EmbeddingStore(self.embeddings, num_nodes=self.num_nodes)

  def tiered_embedding_store(self, hot_rows: int = 0, warm_rows: int = 0,
                             **kwargs) -> TieredEmbeddingStore:
    """The spilled final-layer table as a ``TieredEmbeddingStore``:
    ``hot_rows`` on the device, ``warm_rows`` in host RAM, the rest served
    from the memory-mapped spill (needs ``spill_dir``). ``kwargs`` go to
    ``storage.TieredFeature`` (its device defaults to the
    materializer's)."""
    from ..storage.tiered import TieredFeature
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

  # ------------------------------------------------------------ refresh

  @torch.no_grad()
  def refresh_rows(self, ids) -> np.ndarray:
    """Final-layer-only refresh: recompute the last-layer rows of ``ids``
    from the penultimate store and their full neighbour rows, in a
    ``pow2_cap`` bucket (the engine's stale-node hook). Returns
    ``[len(ids), out_dim]`` host rows."""
    if self._penultimate is None:
      raise RuntimeError('call materialize() first')
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size == 0:
      return np.zeros((0, int(self.model.out_dim)), np.float32)
    cap = pow2_cap(ids.size)
    padded = np.full((cap,), -1, np.int32)
    padded[:ids.size] = ids
    ids_t = torch.as_tensor(padded).to(self.device)
    mask = ids_t >= 0
    safe = torch.clamp(ids_t, min=0)
    nbr_blk = torch.where(mask[:, None], self._nbr[safe.to(torch.int64)], -1)
    x, em = self._gather_block(self._penultimate, safe, nbr_blk)
    if cap not in self._refresh_ei:
      self._refresh_ei[cap] = torch.as_tensor(
          _block_edges(cap, self._w)).to(self.device)
    last = self.num_layers - 1
    slice_fn = train_lib.make_layer_slice_fn(self.model, last, last + 1)
    h = slice_fn(dict(x=x, edge_index=self._refresh_ei[cap], edge_mask=em))
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
