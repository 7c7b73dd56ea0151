"""TieredDistFeature: per-shard out-of-core storage behind the hot-cache
and miss-exchange lookup of ``distributed.DistFeature``.

Counterpart of ``graphlearn_tpu/storage/dist.py``. ``DistFeature`` keeps
every partition's rows in host memory (the ``[P, n_max, F]`` block it
uploads and serves ``cpu_get`` from). This subclass keeps only the
routing structures resident (the sorted ``[P, n_max]`` id table, the
partition book, the replicated hot cache) and moves the row payload to
per-partition memory-mapped disk tiers (``storage.DiskTier``):

* ``cpu_get`` gathers through the mmaps (the page cache is the warm
  tier);
* ``device_arrays`` uploads the full shard table from the tiers one
  partition at a time (never the whole table in host memory), and is
  refused on an oversubscribed store (``hot_prefix_rows > 0``);
* :meth:`dist_scan_tables` uploads only positions ``[0, H)`` of each
  partition (plus the routing structures): the tables of
  ``storage.TieredDistScanTrainer``, whose chunks take the other
  positions from per-chunk staged slabs (the slab-backed owner lookup of
  ``DistFeature._lookup_local``);
* the per-step ``get`` of an oversubscribed store is demand-paged: the
  step's request block comes to the host (one sync a step), its misses
  are routed exactly as the scanned plan routes them
  (``planner.plan_exchange`` over the step as a one-chunk plan), the
  staged positions are gathered from the tiers into a pow2 ``[P, cap]``
  slab and the lookup runs over the hot prefix and that slab, rows
  bit-equal to the all-device store's. Counted as JAX counts it:
  ``storage.demand_pages``, ``storage.demand_paged_rows`` (also into
  ``storage.prefetch_miss``) and the ``storage.demand_page_ms``
  histogram, under one ``storage.demand_page`` span per step.
"""
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import metrics
from ..distributed.dist_feature import INT32_MAX, DistFeature, _torch_dtype
from ..distributed.dist_graph import _to
from ..metrics import spans
from .disk import DiskTier, spill_array


class TieredDistFeature(DistFeature):
  """``DistFeature`` whose per-partition row payloads live on disk.

  Args (beyond ``DistFeature``'s): ``spill_dir``, where the
  per-partition tiers are written when ``feat_parts`` carries in-memory
  arrays (a part's rows may also be a ``DiskTier``, its ids then in
  sorted order, the layout :func:`spill_partitions` writes);
  ``rows_per_chunk`` / ``fmt``, the tiers' layout; ``hot_prefix_rows``,
  the positions of each partition's sorted table kept on the device by
  the oversubscribed paths (0: the full table, as ``DistFeature``).
  """

  def __init__(self, num_partitions: int, feat_parts, feature_pb,
               mesh=None, dtype=None, spill_dir: Optional[str] = None,
               rows_per_chunk: int = 65536, fmt: str = 'npy',
               hot_prefix_rows: int = 0, **kwargs):
    self._spill_dir = spill_dir
    self._rows_per_chunk = int(rows_per_chunk)
    self._fmt = fmt
    self.hot_prefix_rows = int(hot_prefix_rows)
    self._scan_dev = None
    super().__init__(num_partitions, feat_parts, feature_pb, mesh=mesh,
                     dtype=dtype, **kwargs)

  @property
  def device(self):
    return self.mesh.device

  # ------------------------------------------------------------- storage

  def _init_storage(self, feat_parts, dtype):
    first_rows = feat_parts[0][1]
    f = (first_rows.dim if isinstance(first_rows, DiskTier)
         else np.asarray(first_rows).shape[1])
    if dtype is not None:
      np_dt = torch.empty(0, dtype=_torch_dtype(dtype)).numpy().dtype
    else:
      np_dt = (first_rows.dtype if isinstance(first_rows, DiskTier)
               else np.asarray(first_rows).dtype)
    p = len(feat_parts)
    n_max = max((ids.shape[0] for ids, _ in feat_parts), default=1)
    self.n_max = int(n_max)
    self._fdim = int(f)
    self._np_dtype = np.dtype(np_dt)
    self.storage_dtype = torch.from_numpy(
        np.zeros((0,), self._np_dtype)).dtype
    self.feat_ids = np.full((p, n_max), INT32_MAX, np.int32)
    self.feats = None      # the rows live in the tiers
    self._tiers = []
    for i, (ids, rows) in enumerate(feat_parts):
      ids = np.asarray(ids)
      if isinstance(rows, DiskTier):
        if rows.rows != ids.shape[0]:
          raise ValueError(f'partition {i}: tier holds {rows.rows} '
                           f'rows for {ids.shape[0]} ids')
        if ids.size > 1 and np.any(np.diff(ids) < 0):
          raise ValueError(f'partition {i}: a DiskTier part must carry '
                           'rows in sorted-id order (spill_partitions '
                           'writes that layout)')
        self.feat_ids[i, :ids.shape[0]] = ids
        self._tiers.append(rows)
      else:
        if self._spill_dir is None:
          raise ValueError('TieredDistFeature needs spill_dir=... when '
                           'feat_parts carry in-memory arrays (rows are '
                           'written as memory-mapped chunk files)')
        order = np.argsort(ids)
        rows = np.asarray(rows)
        if dtype is not None:
          rows = rows.astype(self._np_dtype)
        self.feat_ids[i, :ids.shape[0]] = ids[order]
        self._tiers.append(spill_array(
            os.path.join(self._spill_dir, f'part_{i:03d}'), rows[order],
            rows_per_chunk=self._rows_per_chunk, fmt=self._fmt))

  def _part_rows(self, p: int) -> int:
    return self._tiers[p].rows

  # -------------------------------------------------------------- access

  def cpu_get(self, ids) -> torch.Tensor:
    """Host-side exact gather through the per-partition mmaps (a CPU
    tensor of the storage dtype), as ``DistFeature.cpu_get`` over the
    same rows."""
    ids = np.asarray(ids)
    out = np.zeros((ids.shape[0], self.feature_dim), self._np_dtype)
    for p in range(self.num_partitions):
      m = self.feature_pb[np.clip(ids, 0, None)] == p
      if not m.any():
        continue
      pos = np.searchsorted(self.feat_ids[p], ids[m])
      pos = np.clip(pos, 0, self.feat_ids.shape[1] - 1)
      real = pos < self._part_rows(p)   # pad slots read as zero rows
      vals = np.zeros((int(m.sum()), self.feature_dim), self._np_dtype)
      if real.any():
        vals[real] = self._tiers[p].gather(pos[real])
      out[m] = vals
    return torch.from_numpy(out)

  def _cache_tables(self):
    h = self.cache_rows
    cache_ids = (self.cache_ids if h else np.full((1,), INT32_MAX, np.int32))
    cache_feats = (self.cache_feats if h else
                   torch.zeros((1, self.feature_dim),
                               dtype=self.storage_dtype))
    mesh = self.mesh
    return dict(feature_pb=_to(mesh, self.feature_pb, torch.int32),
                cache_ids=_to(mesh, cache_ids, torch.int32),
                cache_feats=cache_feats.to(mesh.device))

  def _block(self, p: int, rows: int) -> np.ndarray:
    block = np.zeros((rows, self.feature_dim), self._np_dtype)
    n_p = min(rows, self._part_rows(p))
    if n_p:
      block[:n_p] = self._tiers[p].gather(np.arange(n_p))
    return block

  def device_arrays(self):
    """The full shard table, uploaded from the tiers one partition at a
    time. Refused on an oversubscribed store: with ``hot_prefix_rows``
    set the full ``[P, n_max, F]`` table was declared too large for the
    device (the per-step ``get`` demand-pages, the scanned path stages
    per chunk through ``storage.TieredDistScanTrainer``)."""
    if self.hot_prefix_rows > 0:
      raise RuntimeError(
          f'TieredDistFeature(hot_prefix_rows={self.hot_prefix_rows}) '
          'is oversubscribed: device_arrays() would upload the full '
          f'[{self.num_partitions}, {self.n_max}, {self.feature_dim}] '
          'partition table, defeating the declared oversubscription. '
          'Per-step get() demand-pages (hot prefix + a per-step slab) and '
          'the scanned path stages per chunk (storage.'
          'TieredDistScanTrainer); a consumer that needs the full table '
          'builds the store with hot_prefix_rows=0')
    if self._dev is None:
      mesh = self.mesh
      loc = mesh.local_shards
      feats = torch.empty((len(loc), self.n_max, self.feature_dim),
                          dtype=self.storage_dtype, device=mesh.device)
      for i, p in enumerate(loc):
        feats[i].copy_(torch.from_numpy(self._block(p, self.n_max)))
      self._dev = dict(feat_ids=_to(mesh, self.feat_ids[loc], torch.int32),
                       feats=feats, **self._cache_tables())
    return self._dev

  def gather_positions(self, p: int, positions: np.ndarray) -> np.ndarray:
    """Partition ``p``'s rows by position in its sorted row table (the
    staging read path: positions are what the exchange plan stages and
    what the slab-backed lookup resolves)."""
    return self._tiers[p].gather(np.asarray(positions, np.int64))

  def dist_scan_tables(self):
    """Device tables of the oversubscribed exchange: ``hot [L, H, F]``
    (positions ``[0, H)`` of each local partition, equal to the full
    upload's leading rows), the sorted id table, the book and the cache.
    The full table is never uploaded on this path."""
    if self._scan_dev is None:
      h = self.hot_prefix_rows
      if h < 1:
        raise ValueError(
            'dist_scan_tables needs hot_prefix_rows >= 1 (the chunk '
            'clamps pad positions into the hot prefix): pass '
            'hot_prefix_rows=... to TieredDistFeature')
      mesh = self.mesh
      loc = mesh.local_shards
      hot = torch.empty((len(loc), h, self.feature_dim),
                        dtype=self.storage_dtype, device=mesh.device)
      for i, p in enumerate(loc):
        hot[i].copy_(torch.from_numpy(self._block(p, h)))
      self._scan_dev = dict(
          feat_ids=_to(mesh, self.feat_ids[loc], torch.int32), hot=hot,
          **self._cache_tables())
    return self._scan_dev

  # ---------------------------------------------- per-step demand paging

  def _demand_slab(self, ids_host: np.ndarray, mask_host: np.ndarray):
    """Host miss routing and tier gather for one step's ``[P, b]``
    request block (``planner.plan_exchange`` over the masked ids as a
    one-chunk plan), into the slab layout of ``DistChunkStager``:
    ``(slab_pos [P, cap] int32 sorted + INT32_MAX pads, slab_rows [P,
    cap, F], staged row count)``."""
    from . import planner
    nparts, n_max = self.num_partitions, self.n_max
    masked = np.where(mask_host, ids_host, -1)
    plan = planner.plan_exchange(
        masked, masked.shape[1], self.feature_pb, self.feat_ids,
        self.hot_prefix_rows, cache_ids=self.cache_ids)
    enc = plan.chunk_rows[0]
    cap = plan.slab_caps()[0]
    owners = enc // n_max
    pos = enc % n_max
    counts = (np.bincount(owners, minlength=nparts) if enc.size
              else np.zeros((nparts,), np.int64))
    slab_pos = np.full((nparts, cap), INT32_MAX, np.int32)
    slab_rows = np.zeros((nparts, cap, self.feature_dim), self._np_dtype)
    for p in range(nparts):
      kp = int(counts[p])
      if kp:
        m = owners == p
        slab_pos[p, :kp] = pos[m].astype(np.int32)
        slab_rows[p, :kp] = self.gather_positions(p, pos[m])
    return slab_pos, slab_rows, int(enc.shape[0])

  def _step_tables(self, ids, mask):
    """On an oversubscribed store, the demand page (module docstring):
    the step's ids come to the host (one sync), its slab is gathered and
    uploaded beside the hot prefix."""
    if self.hot_prefix_rows <= 0:
      return None
    mesh = self.mesh
    if mesh.group is not None:
      raise NotImplementedError(
          'the demand-paged get routes every shard\'s requests on one '
          'host: a one-process mesh only')
    ids_host, mask_host = ids.cpu().numpy(), mask.cpu().numpy()
    with spans.span('storage.demand_page', b=int(ids_host.shape[1])):
      t0 = time.perf_counter()
      slab_pos, slab_rows, staged = self._demand_slab(ids_host, mask_host)
      metrics.observe('storage.demand_page_ms',
                      (time.perf_counter() - t0) * 1e3)
      metrics.inc('storage.demand_pages')
      if staged:
        metrics.inc('storage.demand_paged_rows', staged)
        metrics.inc('storage.prefetch_miss', staged)
    return dict(self.dist_scan_tables(),
                slab_pos=_to(mesh, slab_pos, torch.int32),
                slab_rows=torch.from_numpy(slab_rows).to(mesh.device))

  def tier_bytes(self) -> dict:
    """Resident against on-disk bytes (sizing guidance)."""
    disk = sum(t.nbytes for t in self._tiers)
    resident = self.feat_ids.nbytes + self.feature_pb.nbytes
    if self.cache_feats is not None:
      resident += (self.cache_feats.numel() *
                   self.cache_feats.element_size() + self.cache_ids.nbytes)
    return dict(disk_bytes=int(disk), resident_bytes=int(resident))


def spill_partitions(spill_dir: str, feat_parts, rows_per_chunk: int =
                     65536, fmt: str = 'npy'):
  """Write per-partition ``(ids, rows)`` blocks as sorted-id disk tiers
  and return ``[(sorted_ids, DiskTier), ...]``, the layout
  ``TieredDistFeature`` takes directly (an offline step a partitioner
  can run once)."""
  out = []
  for i, (ids, rows) in enumerate(feat_parts):
    ids = np.asarray(ids)
    order = np.argsort(ids)
    tier = spill_array(os.path.join(spill_dir, f'part_{i:03d}'),
                       np.asarray(rows)[order],
                       rows_per_chunk=rows_per_chunk, fmt=fmt)
    out.append((ids[order], tier))
  return out
