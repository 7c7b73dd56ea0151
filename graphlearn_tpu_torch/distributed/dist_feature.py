"""Sharded distributed feature store: a replicated hot cache and a
miss-only exchange.

Counterpart of ``graphlearn_tpu/distributed/dist_feature.py`` (its flat
exchange). A lookup of ``[L, B]`` request blocks (one per local shard)
runs, per shard:

  1. **Hot cache**: the globally hottest ``cache_rows`` rows live on
     every shard. A binary search over the sorted cached ids splits the
     requests into hits and misses; hits read the cache with the row
     gather (``ops.gather_rows_hbm``: one launch of K1 on a card) and
     never enter the exchange.
  2. **Miss dedup**: one request per unique missed id; the response row
     fans back to every slot that asked for it.
  3. **Bucketed exchange**: misses go to their owner in
     ``[P, cap]`` buckets (``ops.route_slots``), ``cap`` being
     ``bucket_frac`` times the mean miss load
     (``ops.exchange_capacity``), or the full width when any shard's
     buckets would overflow (loss-free on every input); on a 2-axis mesh
     the two-stage exchange (``_exchange_hier``). The owner reads its
     rows with K1 at the clamped binary-search position in its sorted
     ids (zeros where not found) and sends them back, in ``wire_dtype``
     when one is given.

The ``[L, 4]`` hit / miss / unique-miss / overflow counters stay on the
device (``stats`` reads them, ``reset_stats`` clears them). JAX decides
the fallback under ``lax.cond`` without leaving the device; here the
exchange's shape depends on it, so each lookup whose fractional capacity
is below the full width reads the summed overflow on the host once
(counted by ``dist_context.verdict_syncs``); ``bucket_frac=None`` reads
nothing. The slab-backed owner lookup (JAX's ``_shard_body(slab=True)``:
rows from a hot prefix or a staged slab) serves
``storage.TieredDistFeature``. ``publish_stats`` (one device read) moves
the counters into the metric registry as ``<prefix>.hits`` etc. and
clears them: the distributed loaders and trainers call it once per
epoch, before the epoch's flight record, so the record's ``feature``
fields equal the published counters.
"""
from typing import Optional

import numpy as np
import torch

from .. import ops
from ..ops.route import exchange_capacity
from ..utils import trace
from .dist_context import count_verdict_sync
from .dist_graph import _to

INT32_MAX = np.iinfo(np.int32).max

# stats accumulator layout (per shard, int32)
STAT_HITS, STAT_MISSES, STAT_UNIQUE, STAT_OVERFLOW = range(4)


def miss_capacity(request_width: int, nparts: int, bucket_frac,
                  hit_rate: float = 0.0) -> int:
  """The per-destination bucket capacity of a miss-only exchange over
  ``request_width`` slots: ``bucket_frac`` times the mean miss load
  (``request_width * (1 - hit_rate)`` over ``nparts``), rounded to 8 and
  clamped to the full width; ``bucket_frac=None`` is the full width."""
  return exchange_capacity(request_width, nparts, bucket_frac, hit_rate)


def feature_exchange_mb(request_width: int, nparts: int, feat_dim: int,
                        bucket_frac=2.0, wire_bytes: int = 4,
                        id_bytes: int = 4, hit_rate: float = 0.0) -> float:
  """Exchange MB per shard per lookup: ``[P, cap]`` id requests and
  ``[P, cap, F]`` row responses."""
  cap = miss_capacity(request_width, nparts, bucket_frac, hit_rate)
  return nparts * cap * (id_bytes + feat_dim * wire_bytes) / 1e6


def _torch_dtype(dtype):
  """A torch dtype from a torch dtype, a numpy dtype or a name."""
  if dtype is None or isinstance(dtype, torch.dtype):
    return dtype
  name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
  return getattr(torch, name)


def exchange_width(mesh, over, width: int, frac_cap: int) -> int:
  """The capacity of one exchange of ``width``-wide requests: the
  fractional ``frac_cap`` unless it is the full width already or some
  shard's buckets overflow it (``over``: ``[L]`` per-shard overflow,
  summed over the mesh and read on the host once, a counted verdict
  sync), else the full width."""
  if frac_cap >= width:
    return width
  count_verdict_sync()
  return frac_cap if int(mesh.psum(over)[0]) == 0 else width


class DistFeature:
  """Per-partition feature rows on the mesh.

  Args:
    num_partitions: the number of partitions (the mesh's shards).
    feat_parts: one ``(ids [n_p], feats [n_p, F])`` per partition (the
      cache already merged by ``partition.cat_feature_cache``).
    feature_pb: ``[N]`` id -> owning partition.
    mesh: a ``ShardMesh``.
    dtype: storage dtype (a torch dtype; default: the rows').
    split_ratio: share of the N globally hottest rows cached on every
      shard.
    cache_rows: the cache's row count (overrides ``split_ratio``).
    hotness: ``[N]`` hotness per id choosing the cached set (None: ids are
      hot-ordered already, row 0 hottest).
    wire_dtype: dtype of the response rows in the exchange (storage and
      results stay ``dtype``).
    bucket_frac: bucket slack over the mean miss load (None: the full
      width).
    dedup: one request per unique missed id.
  """

  def __init__(self, num_partitions: int, feat_parts, feature_pb,
               mesh=None, dtype=None, split_ratio: float = 0.0,
               cache_rows: Optional[int] = None, hotness=None,
               wire_dtype=None, bucket_frac=2.0, dedup: bool = True):
    self.num_partitions = num_partitions
    self.feature_pb = np.asarray(feature_pb)
    self.mesh = mesh
    self._init_storage(feat_parts, dtype)
    self.split_ratio = float(split_ratio)
    self.wire_dtype = _torch_dtype(wire_dtype)
    self.bucket_frac = bucket_frac
    self.dedup = dedup
    n_total = int(self.feature_pb.shape[0])
    h = int(cache_rows) if cache_rows is not None \
        else int(n_total * self.split_ratio)
    h = max(0, min(h, n_total))
    self.cache_rows = h
    # the hit-rate floor sizing the miss buckets: uniform requests hit
    # at H/N, requests skewed to hot rows more
    self._cache_frac = h / n_total if n_total else 0.0
    if h > 0:
      if hotness is None:
        hot_ids = np.arange(h, dtype=np.int64)
      else:
        hotness = np.asarray(hotness).reshape(-1)
        assert hotness.shape[0] == n_total, (
            f'hotness covers {hotness.shape[0]} ids, feature_pb has '
            f'{n_total}')
        hot_ids = np.argsort(-hotness, kind='stable')[:h]
      self.cache_ids = np.sort(hot_ids).astype(np.int32)
      self.cache_feats = self.cpu_get(self.cache_ids)
    else:
      self.cache_ids = None
      self.cache_feats = None
    self._dev = None
    self._stats = None

  def _init_storage(self, feat_parts, dtype):
    """The sorted ``[P, n_max]`` id table and the ``[P, n_max, F]`` row
    store (host)."""
    n_max = max(ids.shape[0] for ids, _ in feat_parts)
    f = feat_parts[0][1].shape[1]
    p = len(feat_parts)
    dt = _torch_dtype(dtype) or torch.as_tensor(feat_parts[0][1][:0]).dtype
    self.n_max = n_max
    self._fdim = int(f)
    self.storage_dtype = dt
    self.feat_ids = np.full((p, n_max), INT32_MAX, np.int32)
    self.feats = torch.zeros((p, n_max, f), dtype=dt)
    for i, (ids, fe) in enumerate(feat_parts):
      ids = np.asarray(ids)
      order = np.argsort(ids)
      self.feat_ids[i, :ids.shape[0]] = ids[order]
      self.feats[i, :ids.shape[0]] = torch.as_tensor(
          np.asarray(fe)[order]).to(dt)

  @property
  def feature_dim(self) -> int:
    return self._fdim

  def device_arrays(self):
    """The mesh's local shards of the id table and rows, the book and
    the cache on the mesh's device (built once)."""
    if self._dev is None:
      mesh = self.mesh
      loc = mesh.local_shards
      h = self.cache_rows
      cache_ids = (self.cache_ids if h else
                   np.full((1,), INT32_MAX, np.int32))
      cache_feats = (self.cache_feats if h else
                     torch.zeros((1, self.feature_dim),
                                 dtype=self.storage_dtype))
      feats = self.feats[loc].contiguous()
      self._dev = dict(
          feat_ids=_to(mesh, self.feat_ids[loc], torch.int32),
          feats=feats.to(mesh.device),
          feature_pb=_to(mesh, self.feature_pb, torch.int32),
          cache_ids=_to(mesh, cache_ids, torch.int32),
          cache_feats=cache_feats.to(mesh.device))
    return self._dev

  # ------------------------------------------------------------ stats
  def _stats_dev(self):
    if self._stats is None:
      self._stats = torch.zeros((self.mesh.num_local, 4), dtype=torch.int32,
                                device=self.mesh.device)
    return self._stats

  def stats(self) -> dict:
    """Host snapshot of the on-device counters, summed over this
    process's shards (one device read: per epoch, not per batch)."""
    tot = (np.zeros((4,), np.int64) if self._stats is None else
           self._stats.sum(0).cpu().numpy().astype(np.int64))
    lookups = int(tot[STAT_HITS] + tot[STAT_MISSES])
    return dict(hits=int(tot[STAT_HITS]), misses=int(tot[STAT_MISSES]),
                unique_misses=int(tot[STAT_UNIQUE]),
                overflow=int(tot[STAT_OVERFLOW]), lookups=lookups,
                hit_rate=(int(tot[STAT_HITS]) / lookups if lookups
                          else 0.0))

  def reset_stats(self):
    self._stats = None

  def publish_stats(self, prefix: str = 'dist_feature') -> dict:
    """Read and clear the on-device counters into the registry's named
    counters (``<prefix>.hits``, ``.misses``, ``.unique_misses``,
    ``.overflow``, ``.lookups``; zeros are not written) — the per-epoch
    surfacing hook. Returns the read :meth:`stats`."""
    s = self.stats()
    for k in ('hits', 'misses', 'unique_misses', 'overflow', 'lookups'):
      if s[k]:
        # graftlint: allow[metric-registry] caller-chosen prefix; both families (dist_feature.*/dist_label.*) are registered wildcards
        trace.counter_inc(f'{prefix}.{k}', s[k])
    self.reset_stats()
    return s

  # ------------------------------------------------------------ lookup
  def _lookup_local(self, d, l: int, flat):
    """Rows for a flat request vector over local shard ``l``'s sorted
    owned ids: K1 at the clamped binary-search position, zeros where
    absent. Slab-backed tables (``d`` holding ``hot`` / ``slab_pos`` /
    ``slab_rows``: JAX's ``_shard_body(slab=True)``) take the row from
    the hot prefix (K1, position < H) or from the staged slab (a
    binary search of its sorted positions; INT32_MAX pads never match)."""
    found, pos = ops.searchsorted_membership(d['feat_ids'][l], flat)
    if 'hot' not in d:
      rows = ops.gather_rows_hbm(d['feats'][l], pos.to(torch.int32))
      return torch.where(found[:, None], rows, 0)
    hot, slab_pos, slab_rows = (d['hot'][l], d['slab_pos'][l],
                                d['slab_rows'][l])
    hp = hot.shape[0]
    hot_rows = ops.gather_rows_hbm(hot, pos.clamp(max=hp - 1).to(
        torch.int32))
    p32 = pos.to(torch.int32)
    sp = torch.searchsorted(slab_pos, p32).clamp_(0, slab_pos.shape[0] - 1)
    in_slab = slab_pos[sp] == p32
    rows = torch.where((pos < hp)[:, None], hot_rows,
                       torch.where(in_slab[:, None], slab_rows[sp], 0))
    return torch.where(found[:, None], rows, 0)

  def _exchange_hier(self, d, req, rmask):
    """The two-stage miss exchange of a 2-axis ``(S, C)`` mesh (JAX's
    ``exchange_hier``): full width along 'chip' to the owner's chip
    column, ``[S, cap2]`` buckets along 'slice' to the owner (``cap2``
    sized on the mean valid miss load over S, with ``bucket_frac``
    slack), the rows back through both transposes. A fractional ``cap2``
    reads the mesh-summed overflow on the host (a counted verdict) and an
    overflowing lookup takes the flat full-width exchange. Returns the
    rows and the ``[L]`` stage-2 overflow counts."""
    mesh = self.mesh
    s_sz, c_sz = mesh.shape
    nparts = self.num_partitions
    nloc, b = req.shape
    fdim = self.feature_dim
    wdtype = self.wire_dtype or self.storage_dtype
    dest = torch.where(rmask, d['feature_pb'][req.clamp(min=0).long()],
                       nparts)
    c_dst = torch.where(rmask, dest % c_sz, c_sz)
    r1 = [ops.route_slots(c_dst[l], rmask[l], capacity=b)
          for l in range(nloc)]
    slot1 = torch.stack([r[0] for r in r1])
    ok1 = torch.stack([r[1] for r in r1])
    send1 = torch.stack([
        ops.scatter_to_buckets(req[l], c_dst[l], slot1[l], ok1[l], c_sz, b)
        for l in range(nloc)])
    mid = mesh.all_to_all(send1, 'chip').reshape(nloc, -1)   # [L, C * b]
    mid_mask = mid >= 0
    mdest = torch.where(mid_mask,
                        d['feature_pb'][mid.clamp(min=0).long()] // c_sz,
                        s_sz)
    r2 = [ops.route_slots(mdest[l], mid_mask[l], capacity=c_sz * b)
          for l in range(nloc)]
    slot2 = torch.stack([r[0] for r in r2])
    ok2f = torch.stack([r[1] for r in r2])
    cap2 = (c_sz * b if self.bucket_frac is None or s_sz <= 1 else
            min(c_sz * b, miss_capacity(b, s_sz, self.bucket_frac,
                                        self._cache_frac)))
    if cap2 >= c_sz * b:
      ovf = torch.zeros((nloc,), dtype=torch.int32, device=req.device)
    else:
      ovf = (mid_mask & (slot2 >= cap2)).sum(1).to(torch.int32)
      count_verdict_sync()
      if int(mesh.psum(ovf)[0]) != 0:
        return self._exchange(d, req, rmask, full=True)[0], ovf
    ok2 = ok2f & (slot2 < cap2)
    send2 = torch.stack([
        ops.scatter_to_buckets(mid[l], mdest[l], slot2[l], ok2[l], s_sz,
                               cap2) for l in range(nloc)])
    req2 = mesh.all_to_all(send2, 'slice')                   # [L, S, cap2]
    rows = torch.stack([
        self._lookup_local(d, l, req2[l].reshape(-1)).to(wdtype)
        .reshape(s_sz, cap2, fdim) for l in range(nloc)])
    r = mesh.all_to_all(rows, 'slice')
    b2 = torch.stack([ops.gather_from_buckets(r[l], mdest[l], slot2[l],
                                              ok2[l], fill=0)
                      for l in range(nloc)])
    r = mesh.all_to_all(b2.reshape(nloc, c_sz, b, fdim), 'chip')
    back = torch.stack([ops.gather_from_buckets(r[l], c_dst[l], slot1[l],
                                                ok1[l], fill=0)
                        for l in range(nloc)]).to(self.storage_dtype)
    return back, ovf

  def _exchange(self, d, req, rmask, full: bool = False):
    """The bucketed miss exchange of ``[L, b]`` requests: rows ``[L, b,
    F]`` in request order (storage dtype) and ``[L]`` overflow counts
    (on a 2-axis mesh :meth:`_exchange_hier`; ``full``: the flat
    full-width exchange, its fallback)."""
    mesh = self.mesh
    if mesh.shape is not None and not full:
      return self._exchange_hier(d, req, rmask)
    nparts = self.num_partitions
    nloc, b = req.shape
    fdim = self.feature_dim
    wdtype = self.wire_dtype or self.storage_dtype
    dest = torch.where(rmask, d['feature_pb'][req.clamp(min=0).long()],
                       nparts)
    routes = [ops.route_slots(dest[l], rmask[l], capacity=b)
              for l in range(nloc)]
    slot = torch.stack([r[0] for r in routes])
    ok = torch.stack([r[1] for r in routes])
    cap_small = (b if full else
                 miss_capacity(b, nparts, self.bucket_frac, self._cache_frac))
    if cap_small >= b:
      ovf = torch.zeros((nloc,), dtype=torch.int32, device=req.device)
    else:
      ovf = (rmask & (slot >= cap_small)).sum(1).to(torch.int32)
    cap = exchange_width(mesh, ovf, b, cap_small)
    okc = ok & (slot < cap)
    send = torch.stack([
        ops.scatter_to_buckets(req[l], dest[l], slot[l], okc[l], nparts, cap)
        for l in range(nloc)])
    recv = mesh.all_to_all(send)                       # [L, P, cap]
    rows = torch.stack([
        self._lookup_local(d, l, recv[l].reshape(-1)).to(wdtype)
        .reshape(nparts, cap, fdim) for l in range(nloc)])
    resp = mesh.all_to_all(rows)                       # [L, P, cap, F]
    back = torch.stack([
        ops.gather_from_buckets(resp[l], dest[l], slot[l], okc[l], fill=0)
        for l in range(nloc)]).to(self.storage_dtype)
    return back, ovf

  def get(self, ids, mask=None):
    """Lookup of per-shard request blocks: ids ``[L, B]`` (this process's
    shards; all P on a one-process mesh) -> ``[L, B, F]``. No host read
    but the counted verdict of a fractional exchange."""
    mesh = self.mesh
    ids = torch.as_tensor(ids).to(mesh.device, torch.int32)
    ids = mesh.local_rows(ids)
    assert ids.dim() == 2
    if mask is None:
      mask = ids >= 0
    else:
      mask = mesh.local_rows(torch.as_tensor(mask).to(mesh.device,
                                                      torch.bool))
    out, batch_stats = self._lookup(ids, mask,
                                    tables=self._step_tables(ids, mask))
    self._stats = self._stats_dev() + batch_stats
    return out

  def _step_tables(self, ids, mask):
    """The tables a per-step ``get`` reads (None: :meth:`device_arrays`;
    the oversubscribed ``storage.TieredDistFeature`` pages its step's
    slab in here)."""
    return None

  def _lookup(self, ids, mask, tables=None):
    """The lookup of ``[L, B]`` local request blocks on the mesh's device
    (JAX's ``_shard_body``): ``([L, B, F] rows, [L, 4] int32 counters of
    this lookup)``. It leaves the store's accumulators alone, so an
    epoch trainer can carry them in its own buffer. ``tables``: the
    device tables (default :meth:`device_arrays`; a slab-backed set for
    the oversubscribed store, see :meth:`_lookup_local`)."""
    d = self.device_arrays() if tables is None else tables
    nloc, b = ids.shape
    fdim, fdtype = self.feature_dim, self.storage_dtype
    h = self.cache_rows
    hits, misses, reqs, rmasks, invs, ucnts, out_hits = \
        [], [], [], [], [], [], []
    for l in range(nloc):
      idl, ml = ids[l], mask[l]
      safe = idl.clamp(min=0)
      if h > 0:
        found, cpos = ops.searchsorted_membership(d['cache_ids'], safe)
        is_hit = ml & found
        rows = ops.gather_rows_hbm(d['cache_feats'], cpos.to(torch.int32))
        out_hit = torch.where(is_hit[:, None], rows, 0)
        miss = ml & ~is_hit
      else:
        is_hit = torch.zeros_like(ml)
        out_hit = None
        miss = ml
      if self.dedup:
        req, ucnt, inverse = ops.masked_unique(idl, miss, size=b)
        rmask = req != ops.FILL
      else:
        req, rmask = idl, miss
        inverse = torch.where(
            miss, torch.arange(b, dtype=torch.int32, device=idl.device), -1)
        ucnt = miss.sum()
      hits.append(is_hit)
      misses.append(miss)
      reqs.append(req)
      rmasks.append(rmask)
      invs.append(inverse)
      ucnts.append(ucnt)
      out_hits.append(out_hit)
    rows, ovf = self._exchange(d, torch.stack(reqs), torch.stack(rmasks))
    outs, batch_stats = [], []
    for l in range(nloc):
      out_miss = rows[l][invs[l].clamp(min=0).long()]
      out = torch.where(misses[l][:, None], out_miss, 0)
      if out_hits[l] is not None:
        out = torch.where(hits[l][:, None], out_hits[l].to(fdtype), out)
      outs.append(out)
      batch_stats.append(torch.stack([
          hits[l].sum(), misses[l].sum(), ucnts[l].to(torch.int64),
          ovf[l].to(torch.int64)]))
    return (torch.stack(outs).reshape(nloc, b, fdim),
            torch.stack(batch_stats).to(torch.int32))

  def cpu_get(self, ids) -> torch.Tensor:
    """Host-side exact gather (a CPU tensor of the storage dtype)."""
    ids = np.asarray(ids)
    out = torch.zeros((ids.shape[0], self.feature_dim),
                      dtype=self.storage_dtype)
    for p in range(self.num_partitions):
      m = self.feature_pb[np.clip(ids, 0, None)] == p
      if not m.any():
        continue
      pos = np.searchsorted(self.feat_ids[p], ids[m])
      pos = np.clip(pos, 0, self.feat_ids.shape[1] - 1)
      out[torch.from_numpy(np.nonzero(m)[0])] = \
          self.feats[p][torch.from_numpy(pos)]
    return out
