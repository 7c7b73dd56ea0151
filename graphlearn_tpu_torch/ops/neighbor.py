"""Fixed-shape neighbor sampling over a device CSR.

Counterpart of ``graphlearn_tpu/ops/neighbor.py`` in torch: a dense
``[B, K]`` draw with a validity mask (deg <= K keeps all neighbors in
order; deg > K draws K with replacement).

- ``uniform_sample`` is the plain version of the fused hop
  (``ops.sample_hop_fused``), whose kernel runs the same draw (``_draw``)
  and the gather in one launch.
- ``weighted_sample`` (with ``build_row_cumsum``), the padded window
  (``build_padded_adjacency*``, ``uniform_sample_padded``,
  ``choose_padded_window``, ``padded_table_stats``) and block sampling
  (``uniform_sample_block``) are the JAX package's XLA-only backends: torch
  ops around one float32 draw per hop (``ops.draw.uniform``).
- ``edge_in_csr`` is the membership test of negative sampling, the plain
  version of the search in ``csrc/negative_sample.cu``.
- ``uniform_sample_local`` / ``weighted_sample_local`` sample a
  partition's local CSR (the distributed engine's hop): a binary search
  for the row, then the fused hop or the weighted path.
"""
import numpy as np
import torch

from .. import random as trandom
from . import draw
from .unique import FILL


def _seed_rows(indptr, meta, seeds, seed_mask):
  """(start, deg) ``[B]`` int32 of each seed's CSR row; masked seeds read
  row 0. ``meta`` is the packed ``[N, 2]`` row table, or None for two
  ``indptr`` reads."""
  safe = torch.where(seed_mask, seeds, 0).long()
  if meta is not None:
    row = meta[safe]
    return row[:, 0].contiguous(), row[:, 1].contiguous()
  start = indptr[safe]
  return start, indptr[safe + 1] - start


def _draw(start, deg, seed_mask, k: int, key):
  """The uniform offset draw (``graphlearn_tpu/ops/sample_fused.py:_draw``).
  The offset is ``floor(u * float32(deg))`` in float32, clamped to ``deg -
  1``; deg <= k keeps the first deg slots in order."""
  b = seed_mask.shape[0]
  u = trandom.uniform(key, (b, k), device=start.device)
  d = deg[:, None]
  rand_off = torch.floor(u * d.to(torch.float32)).to(torch.int32)
  rand_off = torch.minimum(rand_off, torch.clamp(d - 1, min=0))
  seq_off = torch.arange(k, dtype=torch.int32, device=start.device)[None, :]
  offsets = torch.where(d > k, rand_off, seq_off)
  mask = seed_mask[:, None] & (offsets < d)
  epos = start[:, None] + offsets
  return epos, mask


def pick(indices, safe_epos):
  """``indices[safe_epos]``, or zeros for an empty graph (where the draw
  masks every slot)."""
  if indices.shape[0] == 0:
    return torch.zeros_like(safe_epos, dtype=torch.int32)
  return indices[safe_epos.long()]


def uniform_sample(indptr, indices, seeds, seed_mask, k: int, key,
                   meta=None):
  """Sample up to ``k`` neighbors per seed.

  Returns ``(nbrs [B, K] FILL-padded, epos [B, K] 0-padded, mask)``.
  """
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)
  return torch.where(mask, pick(indices, safe_epos), FILL), safe_epos, mask



def _local_rows(row_ids, seeds, seed_mask):
  """``(pos [B] int32, found [B])``: each seed's row in a shard's local
  CSR by a left binary search over its ascending, INT32_MAX-padded
  ``row_ids`` (``jnp.searchsorted``'s side); a seed the shard does not
  own, or a masked one, is not found."""
  seeds = seeds.to(row_ids.dtype)
  pos = torch.clamp(torch.searchsorted(row_ids, seeds), 0,
                    row_ids.shape[0] - 1)
  found = (row_ids[pos] == seeds) & seed_mask
  return pos.to(torch.int32), found


def uniform_sample_local(row_ids, indptr_loc, indices, seeds, seed_mask,
                         k: int, key):
  """Uniform fanout sampling over a partition-local CSR
  (``graphlearn_tpu/ops/neighbor.py:uniform_sample_local``).

  A shard stores its owned rows only: ``row_ids`` lists their global ids
  ascending (INT32_MAX-padded) and ``indptr_loc`` their local offsets.
  The row is found by a binary search; then the hop is
  ``sample_hop_fused`` on the local CSR at that row with the mask
  ``found`` (one launch of the hop kernel on a card, ``uniform_sample``
  on the CPU): JAX's draw, offsets and masked positions exactly. Seeds
  the shard does not own come back masked. Same output contract as
  :func:`uniform_sample`.
  """
  from .sample_fused import sample_hop_fused
  pos, found = _local_rows(row_ids, seeds, seed_mask)
  return sample_hop_fused(indptr_loc, indices, None, pos, found, k, key)


def weighted_sample_local(row_ids, indptr_loc, indices, row_cumsum, seeds,
                          seed_mask, k: int, key):
  """Edge-weight-biased fanout sampling over a partition-local CSR
  (``graphlearn_tpu/ops/neighbor.py:weighted_sample_local``): the row
  lookup of :func:`uniform_sample_local`, then :func:`weighted_sample`
  over the shard's row CDF (``build_row_cumsum`` of the local CSR); its
  draw is one launch of the draw kernel on a card. Same output contract
  as :func:`uniform_sample_local`."""
  pos, found = _local_rows(row_ids, seeds, seed_mask)
  return weighted_sample(indptr_loc, indices, row_cumsum, pos, found, k,
                         key)


# ---------------------------------------------------------------------------
# The other sampling backends: weighted, padded window, block. Each hop's
# uniforms come from ``draw.uniform`` (one launch of csrc/uniform_draw.cu on
# the card, ``random.uniform`` on the CPU); the rest is torch ops.


def _long(t):
  return t.to(torch.int64)


_CDF_ROW_SPLIT = 1024   # rows longer than this get their own np.cumsum


def build_row_cumsum(indptr, weights) -> np.ndarray:
  """Per-edge cumulative weight restarting at each row (so
  ``cum[indptr[r]:indptr[r+1]]`` is row r's CDF), built on the host.

  Counterpart of ``graphlearn_tpu/ops/neighbor.py:build_row_cumsum``,
  computed exactly where that one is not: JAX takes one float32 cumsum
  over all edges and subtracts each row's base, so past a running total
  of 2**24 it stops adding whole weights (a row's first edge can get
  weight 0 and never be drawn). Here each row's CDF is a float64
  sequential sum over the row alone, stored as float32: numpy's float64
  row CDF, rounded once. The two agree wherever JAX's float32 running
  total is exact (e.g. dyadic weights with a total below 2**24).

  Rows of degree <= 1024 are summed together, by position within the
  row (step j adds weight j to every row longer than j); each longer row
  is one ``np.cumsum`` (at most E / 1024 of them). Returns ``[E]``
  float32 (numpy).
  """
  indptr = np.asarray(indptr, dtype=np.int64)
  w = np.asarray(weights, dtype=np.float64).reshape(-1)
  deg = np.diff(indptr)
  cum = np.empty_like(w)
  long_rows = deg > _CDF_ROW_SPLIT
  for r in np.flatnonzero(long_rows):
    cum[indptr[r]:indptr[r + 1]] = np.cumsum(w[indptr[r]:indptr[r + 1]])
  short = np.flatnonzero(~long_rows)
  order = short[np.argsort(-deg[short], kind='stable')]   # longest first
  starts = indptr[:-1][order]
  sdeg = deg[order]
  for j in range(int(sdeg.max(initial=0))):
    live = int(np.searchsorted(-sdeg, -j, side='left'))   # rows with deg > j
    pos = starts[:live] + j
    cum[pos] = w[pos] if j == 0 else cum[pos - 1] + w[pos]
  return cum.astype(np.float32)


def weighted_sample(indptr, indices, row_cumsum, seeds, seed_mask, k: int,
                    key):
  """Edge-weight-biased sampling with replacement by inverse-CDF
  bisection (``graphlearn_tpu/ops/neighbor.py:weighted_sample``).

  ``row_cumsum`` is the ``[E]`` float32 row CDF (:func:`build_row_cumsum`)
  on the tensors' device. Rows with deg <= k keep all their neighbours;
  the others draw ``u * total`` in float32 (as JAX does, not promoted) and
  take the first position whose CDF reaches it, by 32 bisection steps.
  Same output contract as :func:`uniform_sample`.
  """
  dev = seeds.device
  b = seeds.shape[0]
  safe = _long(torch.where(seed_mask, seeds, 0))
  start = _long(indptr[safe])
  end = _long(indptr[safe + 1])
  deg = end - start
  e = row_cumsum.shape[0]
  if e == 0:     # no edge: every slot is masked
    z = torch.zeros((b, k), dtype=torch.int32, device=dev)
    return z - 1, z, torch.zeros((b, k), dtype=torch.bool, device=dev)
  total = row_cumsum[torch.clamp(end - 1, min=0)]
  total = torch.where(deg > 0, total, torch.ones((), dtype=total.dtype,
                                                  device=dev))
  u = draw.uniform(key, (b, k), dev) * total[:, None]
  lo = start[:, None].expand(b, k)
  hi = end[:, None].expand(b, k)
  for _ in range(32):
    mid = (lo + hi) // 2
    go_right = row_cumsum[torch.clamp(mid, 0, e - 1)] < u
    lo = torch.where(go_right, mid + 1, lo)
    hi = torch.where(go_right, hi, mid)
  wpos = torch.minimum(lo, torch.clamp(end[:, None] - 1, min=0))
  seq = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
  big = deg[:, None] > k
  epos = torch.where(big, wpos, start[:, None] + seq)
  mask = seed_mask[:, None] & (torch.where(big, 0, seq) < deg[:, None])
  safe_epos = torch.where(mask, epos, 0).to(torch.int32)
  return torch.where(mask, pick(indices, safe_epos), FILL), safe_epos, mask


def choose_padded_window(fanouts, candidates=(16, 64, 128)) -> int:
  """The padded-adjacency window for a fanout list: the first candidate
  that covers ``max(fanouts)`` (a smaller window would under-sample), else
  the next power of two. The candidates are the JAX package's own list
  (``graphlearn_tpu/ops/neighbor.py:choose_padded_window``), kept for
  parity: W = 32 is absent from it because of an XLA code-generation
  effect on the TPU, which says nothing of the card; ``chip_smoke.py``
  times W = 16, 32 and 64 on the H100 (PERF.md)."""
  need = max(fanouts)
  for w in candidates:
    if w >= need:
      return w
  return _round_up_pow2(need)


def _round_up_pow2(n: int) -> int:
  w = 1
  while w < n:
    w *= 2
  return w


def padded_table_stats(indptr, window: int):
  """Degree-conditional neighbour recall of a ``[N, window]`` padded
  table (rows with deg > window expose a random window-subset per epoch).
  ``node_recall``: mean over nodes with deg > 0 of min(deg, W)/deg;
  ``edge_recall``: sum(min(deg, W)) / sum(deg); the fractions of
  truncated nodes and edges; ``recall_by_degree``: mean node recall per
  degree decile (keyed by the decile's upper bound). numpy, as in JAX."""
  indptr = np.asarray(indptr)
  deg = np.diff(indptr).astype(np.int64)
  pos = deg[deg > 0]
  kept = np.minimum(pos, window)
  stats = {
      'window': int(window),
      'node_recall': float((kept / pos).mean()) if pos.size else 1.0,
      'edge_recall': float(kept.sum() / max(pos.sum(), 1)),
      'frac_truncated_nodes': float((pos > window).mean()) if pos.size
      else 0.0,
      'frac_truncated_edges': float(pos[pos > window].sum()
                                    / max(pos.sum(), 1)),
  }
  if pos.size:
    qs = np.quantile(pos, np.linspace(0.1, 1.0, 10))
    by_dec = {}
    lo = 0
    for q in qs:
      sel = (pos > lo) & (pos <= q)
      if sel.any():
        by_dec[int(q)] = float((kept[sel] / pos[sel]).mean())
      lo = q
    stats['recall_by_degree'] = by_dec
  return stats


def build_padded_adjacency(indptr, indices, window: int, seed: int = 0,
                           edge_pos: bool = False):
  """Host-side dense ``[N, window]`` neighbour table, each row shuffled
  (numpy's generator) and cut at the window
  (``graphlearn_tpu/ops/neighbor.py:build_padded_adjacency``, copied).

  Returns ``(nbr_table [N, W] int32 FILL-padded, deg [N] int32 =
  min(degree, W), epos_table [N, W] int32 or None)``, numpy arrays.
  """
  indptr = np.asarray(indptr)
  indices = np.asarray(indices)
  n = indptr.shape[0] - 1
  e = indices.shape[0]
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
  order = np.lexsort((rng.random(e), rows))     # shuffle within each row
  shuf_rows = rows[order]
  shuf_within = np.arange(e, dtype=np.int64) - np.repeat(
      indptr[:-1], np.diff(indptr))
  sel = shuf_within < window
  tab = np.full((n, window), FILL, np.int32)
  tab[shuf_rows[sel], shuf_within[sel]] = indices[order][sel]
  deg = np.minimum(np.diff(indptr), window).astype(np.int32)
  epos = None
  if edge_pos:
    epos = np.zeros((n, window), np.int32)
    epos[shuf_rows[sel], shuf_within[sel]] = order[sel]
  return tab, deg, epos


def build_padded_adjacency_device(indptr, indices, window: int, key,
                                  edge_pos: bool = False):
  """:func:`build_padded_adjacency` on the CSR's device, from a threefry
  key (``graphlearn_tpu/ops/neighbor.py:build_padded_adjacency_device``).

  One float32 draw per edge (``draw.uniform``: one launch on the card),
  then the edges ordered by (row, draw) with ties kept in edge order, as
  JAX's stable two-key ``lax.sort`` keeps them (25M float32 draws from 23
  mantissa bits do tie): two stable sorts, by the draw and then by the
  row. Position j of row r lands in ``tab[r, j]``; positions past the
  window are dropped (scattered into a spare slot), as ``mode='drop'``
  drops them. No host sync. Returns ``(tab [N, W] int32, deg [N] int32,
  epos [N, W] int32 or None)`` on the CSR's device.
  """
  dev = indices.device
  e = indices.shape[0]
  n = indptr.shape[0] - 1
  counts = _long(indptr[1:] - indptr[:-1])
  rows = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                 output_size=e)
  rand = draw.uniform(key, (e,), dev)
  o1 = torch.sort(rand, stable=True).indices
  order = o1[torch.sort(rows[o1], stable=True).indices]
  within = torch.arange(e, device=dev) - torch.repeat_interleave(
      _long(indptr[:-1]), counts, output_size=e)
  slot = torch.where(within < window, rows * window + within, n * window)

  def scatter(vals, fill):
    buf = torch.full((n * window + 1,), fill, dtype=torch.int32, device=dev)
    buf.scatter_(0, slot, vals.to(torch.int32))
    return buf[:-1].view(n, window)

  tab = scatter(indices[order], FILL)
  deg = torch.clamp(counts, max=window).to(torch.int32)
  epos = scatter(order, 0) if edge_pos else None
  return tab, deg, epos


def uniform_sample_padded(nbr_table, deg, seeds, seed_mask, k: int, key,
                          epos_table=None):
  """Uniform fanout sampling over a padded table
  (``graphlearn_tpu/ops/neighbor.py:uniform_sample_padded``): one row
  gather of ``[B, W]``, the uniform offset draw of :func:`uniform_sample`
  over ``min(deg, W)``, and the in-row pick by ``torch.gather`` (JAX's
  one-hot sum gives the same values). ``epos`` is zeros without
  ``epos_table``. Same output contract as :func:`uniform_sample`."""
  dev = seeds.device
  b = seeds.shape[0]
  safe = _long(torch.where(seed_mask, seeds, 0))
  rows = nbr_table[safe]
  d = torch.where(seed_mask, deg[safe], 0)[:, None]
  u = draw.uniform(key, (b, k), dev)
  rand_off = torch.floor(u * d.to(torch.float32)).to(torch.int32)
  rand_off = torch.minimum(rand_off, torch.clamp(d - 1, min=0))
  seq = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
  offsets = torch.where(d > k, rand_off, seq)
  mask = seed_mask[:, None] & (offsets < d)
  safe_off = _long(torch.where(mask, offsets, 0))
  nbrs = torch.where(mask, torch.gather(rows, 1, safe_off), FILL)
  if epos_table is None:
    return nbrs, torch.zeros_like(nbrs), mask
  ep = torch.gather(epos_table[safe], 1, safe_off)
  return nbrs, torch.where(mask, ep, 0), mask


BLOCK = 16  # aligned CSR block width of block sampling


def uniform_sample_block(csr_meta, indices_blocks, num_edges: int, seeds,
                         seed_mask, k: int, key):
  """Block (cluster) fanout sampling over the raw CSR
  (``graphlearn_tpu/ops/neighbor.py:uniform_sample_block``).

  ``csr_meta`` is the ``[N, 2]`` (start, degree) table, ``indices_blocks``
  the FILL-padded indices viewed ``[ceil(E/16), 16]``, ``num_edges`` the
  true E. The hop key is split in two (``random.split``, torch ops on the
  key's device): the first draws one position per seed, whose block is
  gathered (with the next one, for keep-all rows that straddle into it);
  the second draws the k slots within the seed's part of that block.
  Marginals are exactly uniform; a row's draws within one hop share a
  block. Same output contract as :func:`uniform_sample`.
  """
  assert k <= BLOCK, 'block sampling supports fanouts up to BLOCK=16'
  dev = seeds.device
  b = seeds.shape[0]
  nblocks = indices_blocks.shape[0]
  safe = _long(torch.where(seed_mask, seeds, 0))
  meta = csr_meta[safe]
  start = meta[:, 0]
  deg = torch.where(seed_mask, meta[:, 1], 0)
  small = deg <= k                                  # keep-all branch
  ku, kk = trandom.split(torch.as_tensor(key).to(dev))
  u = draw.uniform(ku, (b,), dev)
  p = start + torch.minimum((u * deg.to(torch.float32)).to(torch.int32),
                            torch.clamp(deg - 1, min=0))
  blk = torch.clamp(torch.where(small, start // BLOCK, p // BLOCK), 0,
                    nblocks - 1)
  blk_base = blk * BLOCK
  rows = torch.cat([indices_blocks[_long(blk)],
                    indices_blocks[_long(torch.clamp(blk + 1, 0,
                                                     nblocks - 1))]], 1)
  lo = torch.maximum(start, blk_base) - blk_base    # valid in-block range
  hi = torch.minimum(start + deg, blk_base + BLOCK) - blk_base
  width = torch.clamp(hi - lo, min=0)[:, None]
  u2 = draw.uniform(kk, (b, k), dev)
  off_rand = lo[:, None] + torch.minimum(
      (u2 * width.to(torch.float32)).to(torch.int32),
      torch.clamp(width - 1, min=0))
  seq = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
  off = torch.where(small[:, None], (start - blk_base)[:, None] + seq,
                    off_rand)
  mask = seed_mask[:, None] & torch.where(small[:, None], seq < deg[:, None],
                                          width > 0)
  # off lies in [0, 2 * BLOCK) on every valid slot: the anchor block or
  # its successor
  picked = torch.gather(rows, 1, _long(torch.clamp(off, 0, 2 * BLOCK - 1)))
  epos = torch.where(mask, blk_base[:, None] + off, 0)
  epos = torch.minimum(epos, torch.full((), num_edges - 1, dtype=epos.dtype,
                                        device=dev))
  return torch.where(mask, picked, FILL), epos, mask


def edge_in_csr(indptr, indices, rows, cols):
  """Is ``(rows[i], cols[i])`` an edge? (``graphlearn_tpu/ops/
  neighbor.py:edge_in_csr``). ``indices`` must be sorted within each row
  segment (``ops.sort_csr_segments``): a lower-bound binary search of 32
  rounds, the probe index clipped into the indices, and the row pointer
  reads clamped into ``indptr`` as XLA's gather clamps them."""
  last = indptr.shape[0] - 1
  r = _long(rows)
  start = _long(indptr[r.clamp(0, last)])
  end = _long(indptr[(r + 1).clamp(0, last)])
  n_e = indices.shape[0]
  if n_e == 0:
    return torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
  lo, hi = start, end
  for _ in range(32):
    mid = (lo + hi) // 2
    right = indices[mid.clamp(0, n_e - 1)] < cols
    lo = torch.where(right, mid + 1, lo)
    hi = torch.where(right, hi, mid)
  return (lo < end) & (indices[lo.clamp(0, n_e - 1)] == cols)
