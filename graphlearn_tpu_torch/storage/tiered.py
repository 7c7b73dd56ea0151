"""TieredFeature: the three-tier device -> host RAM -> disk feature store.

Counterpart of ``graphlearn_tpu/storage/tiered.py``. Storage rows
``[0, H)`` are on the device (the hot prefix, after the hotness
reorder), ``[H, H+W)`` live in host RAM (the warm tier, a copy of the
source's rows) and ``[H+W, N)`` on disk as memory-mapped chunk files
(``storage/disk.py``), so a table beyond host RAM backs a store whose RAM
holds only the warm prefix.

``TieredFeature`` subclasses ``data.Feature`` and plugs in where a
Feature is read: the loaders' lookup (``feature[ids]``), ``cpu_get``
and the serving store. Cold rows first consult a bounded cache of
promoted blocks (rows a reactive lookup already read), then fall back to
a synchronous mmap gather counted in ``storage.prefetch_miss`` and
promoted, as in JAX.

A lookup on a card:

- The warm block lives on pages of its own, page-locked and mapped for
  the card (``ops.mapped``, registered once, released after the last
  launch that read it), and one launch of the hot/cold kernel
  (``ops.gather_rows_unified``) reads the hot rows from the device and
  the warm rows over UVA.
- The card cannot read the disk tier. Ids on the device are read to the
  host once (one host sync per lookup, and only when the store has a
  disk tier; JAX's mixed gather reads them too); the disk rows are
  resolved there, shipped in one pinned copy and scattered into place.
  Ids given on the host cost no sync. ``host_syncs`` counts the syncs.

On the CPU a lookup is JAX's mixed gather: the non-hot rows resolved on
the host and shipped padded to a power of two (``_last_cold_cap``).

The scanned epoch over this store, with its whole miss set planned up
front and staged ahead of each chunk, is ``storage.TieredScanTrainer``.
"""
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import metrics, ops
from ..data.feature import Feature, _fill_value
from ..data.unified_tensor import UnifiedTensor
from ..utils import resolve_device
from .disk import DiskTier, spill_array


class _PromotedCache:
  """Bounded FIFO of promoted cold-row blocks, searched newest-first by
  sorted absolute storage row (the reactive half of the warm tier)."""

  def __init__(self, capacity_rows: int):
    self.capacity_rows = int(capacity_rows)
    self._blocks: List[Tuple[np.ndarray, np.ndarray]] = []
    self._rows = 0
    self._lock = threading.Lock()

  def put(self, abs_rows_sorted: np.ndarray, rows: np.ndarray):
    if self.capacity_rows <= 0 or abs_rows_sorted.size == 0:
      return
    with self._lock:
      self._blocks.append((abs_rows_sorted, rows))
      self._rows += int(abs_rows_sorted.shape[0])
      while self._rows > self.capacity_rows and len(self._blocks) > 1:
        old_ids, _ = self._blocks.pop(0)
        self._rows -= int(old_ids.shape[0])

  def lookup(self, abs_rows: np.ndarray, out: np.ndarray,
             missing: np.ndarray) -> np.ndarray:
    """Fill ``out`` rows found in the cache; returns the updated
    ``missing`` mask (True = still unresolved)."""
    with self._lock:
      blocks = list(self._blocks)
    for ids, rows in reversed(blocks):
      if not missing.any():
        break
      pos = np.searchsorted(ids, abs_rows)
      pos = np.clip(pos, 0, ids.shape[0] - 1)
      hit = missing & (ids[pos] == abs_rows)
      if hit.any():
        out[hit] = rows[pos[hit]]
        missing = missing & ~hit
    return missing

  @property
  def rows(self) -> int:
    with self._lock:
      return self._rows


class _TieredTensor(UnifiedTensor):
  """A ``UnifiedTensor`` whose host span stacks the warm block (its host
  part, mapped on a card) over a disk tier."""

  def __init__(self, warm: Optional[np.ndarray], disk: Optional[DiskTier],
               disk_base: int, promoted: _PromotedCache, np_dtype,
               device=None, dtype=None):
    super().__init__(device=device, dtype=dtype)
    # the dtype of the rows a lookup returns (the parts' storage dtype)
    self._out_dtype = (dtype if dtype is not None else
                       torch.from_numpy(np.zeros((0,), np_dtype)).dtype)
    self._warm = warm
    self._disk = disk
    # tier-relative offset of storage row H+W inside the DiskTier: 0 when
    # the tier holds only the cold tail, H+W when it holds all N rows
    self._disk_base = int(disk_base)
    self._promoted = promoted
    self._warm_n = int(warm.shape[0]) if warm is not None else 0
    self._disk_n = int(disk.rows - disk_base) if disk is not None else 0
    self.host_syncs = 0   # device-id lookups that read their ids back

  @property
  def shape(self):
    f = (self._device_part.shape[1] if self._device_part is not None else
         self._warm.shape[1] if self._warm is not None else self._disk.dim)
    return (self._device_rows + self._host_rows_n, int(f))

  def _host_resolve(self, rel_ids: np.ndarray) -> np.ndarray:
    """Rows for host-relative indices ``[0, W + D)``: warm rows from RAM,
    cold rows from the promoted cache, else from disk (counted in
    ``storage.prefetch_miss`` and promoted)."""
    rel_ids = np.asarray(rel_ids, np.int64).reshape(-1)
    dim = (self._warm.shape[1] if self._warm is not None
           else self._disk.dim)
    dt = (self._warm.dtype if self._warm is not None else self._disk.dtype)
    out = np.zeros((rel_ids.shape[0], dim), dt)
    is_warm = rel_ids < self._warm_n
    if is_warm.any():
      out[is_warm] = self._warm[rel_ids[is_warm]]
    cold = ~is_warm
    if cold.any():
      # absolute storage rows key the promoted cache
      abs_rows = rel_ids[cold] + self._device_rows
      block = np.zeros((int(cold.sum()), dim), dt)
      missing = np.ones((block.shape[0],), bool)
      missing = self._promoted.lookup(abs_rows, block, missing)
      if missing.any():
        metrics.inc('storage.prefetch_miss', int(missing.sum()))
        disk_rel = (rel_ids[cold][missing] - self._warm_n + self._disk_base)
        read = self._disk.gather(disk_rel)
        block[missing] = read
        # promote: repeated reactive access to the same cold rows warms
        order = np.argsort(abs_rows[missing], kind='stable')
        self._promoted.put(abs_rows[missing][order], read[order])
      out[cold] = block
    return out

  def _rows_tensor(self, rows: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(rows).to(self._out_dtype)

  def gather_host(self, rows: torch.Tensor) -> torch.Tensor:
    """Rows at storage rows ``rows`` (a CPU int64 tensor, in ``[0,
    N)``), on this tensor's device."""
    if self.device.type == 'cpu':
      return self._gather_cpu(rows)
    return self._gather_card(rows)

  def _gather_cpu(self, r: torch.Tensor) -> torch.Tensor:
    """JAX's mixed gather: non-hot rows resolved on the host, shipped
    padded to a power of two, scattered into the hot gather."""
    h = self._device_rows
    if h == 0:
      return self._rows_tensor(self._host_resolve(r.numpy()))
    b = r.shape[0]
    is_hot = r < h
    cold_pos = torch.nonzero(~is_hot).squeeze(1)
    n_cold = int(cold_pos.shape[0])
    cold_cap = min(b, max(1, ops.gather.next_pow2(n_cold)))
    self._last_cold_cap = cold_cap
    block = torch.zeros((cold_cap, self.shape[1]), dtype=self._out_dtype)
    if n_cold:
      block[:n_cold] = self._rows_tensor(
          self._host_resolve(r[cold_pos].numpy() - h))
    out = self._device_part.index_select(0, torch.where(is_hot, r, 0))
    out.index_copy_(0, cold_pos, block[:n_cold])
    return out

  def _gather_card(self, r: torch.Tensor) -> torch.Tensor:
    """One hot/cold kernel launch over the hot and warm rows; the disk
    rows resolved on the host and scattered in with one pinned copy."""
    dev = self.device
    edge = self._device_rows + self._warm_n
    r_dev = r.pin_memory().to(dev, non_blocking=True)
    if edge:
      out = ops.gather_rows_unified(self._hot(), self._cold_rows(), r_dev)
    else:
      out = torch.empty((r.shape[0], self.shape[1]),
                        dtype=self._out_dtype, device=dev)
    if self._disk_n:
      pos = torch.nonzero(r >= edge).squeeze(1)
      if pos.numel():
        rows = self._rows_tensor(
            self._host_resolve(r[pos].numpy() - self._device_rows))
        out.index_copy_(0, pos.pin_memory().to(dev, non_blocking=True),
                        rows.pin_memory().to(dev, non_blocking=True))
    return out

  def _cold_rows(self) -> torch.Tensor:
    if self._host_part is not None:
      return self._host_part
    return torch.empty((0, self.shape[1]), dtype=self._out_dtype)

  def __getitem__(self, ids) -> torch.Tensor:
    """Rows at storage rows ``ids`` (clamped to ``[0, N)``), on this
    tensor's device. Device ids are read back once when there is a disk
    tier, else the lookup is the hot/cold kernel alone."""
    if torch.is_tensor(ids) and ids.device.type != 'cpu':
      if not self._disk_n:
        ids = ids.contiguous()
        if ids.dtype not in (torch.int32, torch.int64):
          ids = ids.long()
        return ops.gather_rows_unified(self._hot(), self._cold_rows(), ids)
      ids = ids.cpu()     # the lookup's one host sync
      self.host_syncs += 1
    r = torch.as_tensor(ids).long().clamp(0, max(self.size - 1, 0))
    return self.gather_host(r)


class TieredFeature(Feature):
  """Three-tier drop-in for ``data.Feature``.

  Args:
    source: the full ``[N, F]`` table: an in-RAM ``np.ndarray`` (its cold
      tail is spilled to ``spill_dir``), OR a ``DiskTier`` holding all N
      rows (hot and warm prefixes are read from it once at init), OR a
      path to such a tier.
    hot_rows: H, rows ``[0, H)`` on the device.
    warm_rows: W, rows ``[H, H+W)`` in host RAM. None with an array
      source means "everything not hot stays warm" (no disk tier); None
      with a disk source means W = 0.
    id2index: optional ``[N]`` node-id -> storage-row map from the
      hotness reorder, as in ``data.Feature``.
    dtype: optional torch dtype of the rows lookups return (the device
      tier's and the mapped warm block's storage dtype).
    device: torch device of the hot tier and of lookups' results (None
      means the card).
    spill_dir: where to write the cold tail when ``source`` is an array
      and cold rows exist (required in that case).
    rows_per_chunk / fmt: DiskTier layout of the spill.
    promoted_rows: capacity of the bounded promoted-row cache reactive
      cold reads warm into (0 disables promotion).
  """

  def __init__(self, source, hot_rows: int = 0,
               warm_rows: Optional[int] = None,
               id2index: Optional[np.ndarray] = None, dtype=None,
               device=None, spill_dir: Optional[str] = None,
               rows_per_chunk: int = 65536, fmt: str = 'npy',
               promoted_rows: int = 65536):
    if isinstance(source, str):
      source = DiskTier(source)
    disk, hot_np, warm_np = None, None, None
    if isinstance(source, DiskTier):
      n = source.rows
      hot = max(0, min(int(hot_rows), n))
      w = 0 if warm_rows is None else int(warm_rows)
      warm = max(0, min(w, n - hot))
      disk, disk_base = source, hot + warm
      if hot:
        hot_np = source.gather(np.arange(hot))
      if warm:
        warm_np = source.gather(np.arange(hot, disk_base))
      f, np_dtype = source.dim, source.dtype
    else:
      arr = np.asarray(source)
      n = arr.shape[0]
      hot = max(0, min(int(hot_rows), n))
      w = (n - hot) if warm_rows is None else int(warm_rows)
      warm = max(0, min(w, n - hot))
      cold = n - hot - warm
      # copies, not views: a slice view pins the whole source array in
      # host RAM for the store's lifetime; the caller must be able to
      # drop the source and keep only hot + warm resident
      hot_np = arr[:hot].copy() if hot else None
      warm_np = arr[hot:hot + warm].copy() if warm else None
      disk_base = 0
      if cold:
        if spill_dir is None:
          raise ValueError(
              f'{cold} rows fall in the disk tier but no spill_dir was '
              'given: pass spill_dir=... (the cold tail is written as '
              'memory-mapped chunk files), or widen hot/warm to cover '
              'the table')
        disk = spill_array(spill_dir, arr[hot + warm:],
                           rows_per_chunk=rows_per_chunk, fmt=fmt)
      f, np_dtype = int(arr.shape[1]), arr.dtype
    self._setup(hot_np, warm_np, disk, disk_base, n, f, np_dtype, id2index,
                dtype, device, promoted_rows)

  def _setup(self, hot_np, warm_np, disk, disk_base, n, f, np_dtype,
             id2index, dtype, device, promoted_rows):
    self._disk = disk
    self._disk_base = int(disk_base)
    self._hot_np, self._warm_np = hot_np, warm_np
    self.hot_rows = int(hot_np.shape[0]) if hot_np is not None else 0
    self.warm_rows = int(warm_np.shape[0]) if warm_np is not None else 0
    self._n, self._f, self._np_dtype = int(n), int(f), np.dtype(np_dtype)
    self.disk_rows = self._n - self.hot_rows - self.warm_rows
    # the Feature surface (no super().__init__: the base keeps the whole
    # table, which is what this store must not hold)
    self.split_ratio = self.hot_rows / self._n if self._n else 0.0
    self.cache_rows = self.hot_rows
    self.device_group_list = None
    self.device = resolve_device(device)
    self.with_device = self.hot_rows > 0
    self._id2index = (np.asarray(id2index) if id2index is not None
                      else None)
    self.dtype = dtype
    self._unified = None
    self._id2index_dev = None
    self._kernel_routing = None
    self._promoted = _PromotedCache(promoted_rows)

  # ------------------------------------------------------------ lifecycle

  def lazy_init(self):
    if self._unified is not None:
      return
    ut = _TieredTensor(self._warm_np, self._disk, self._disk_base,
                       self._promoted, self._np_dtype, device=self.device,
                       dtype=self.dtype)
    # the hot block on the device; the warm block mapped for the card
    # (copied once onto pages of its own) or kept as a CPU tensor
    ut.init_from(self._hot_np, self._warm_np)
    warm_t = ut.host_part
    if warm_t is not None and ut.device.type == 'cuda' and \
        warm_t.dtype == ut._out_dtype and \
        np.dtype(warm_t.numpy().dtype) == self._np_dtype:
      # the mapped copy serves the host reads too: one warm copy in RAM
      self._warm_np = ut._warm = warm_t.numpy()
    # init_from saw only the warm block: stamp the whole host span
    ut._host_rows_n = self.warm_rows + self.disk_rows
    self._unified = ut
    if self._id2index is not None:
      self._id2index_dev = torch.as_tensor(self._id2index).to(self.device)
    metrics.set_gauge('storage.hot_rows', self.hot_rows)
    metrics.set_gauge('storage.warm_rows', self.warm_rows)
    metrics.set_gauge('storage.disk_rows', self.disk_rows)

  @property
  def host_syncs(self) -> int:
    """Lookups that read device ids back to the host (one each)."""
    return self._unified.host_syncs if self._unified is not None else 0

  # ------------------------------------------------------- Feature surface

  @property
  def feature_array(self):
    raise AttributeError(
        'TieredFeature holds no resident full table: use cpu_get / '
        '__getitem__ (tiers resolve per request), or stage_gather for '
        'planned blocks')

  @property
  def shape(self):
    return (self._n, self._f)

  @property
  def size(self) -> int:
    return self._n

  def __getitem__(self, ids) -> torch.Tensor:
    """Rows for global node ids, as ``Feature[ids]``: FILL (-1) slots
    read storage row 0 after the remap; an id past the table gives the
    fill row. Ids on the device with a disk tier cost one host sync."""
    self.lazy_init()
    ut = self._unified
    if torch.is_tensor(ids) and ids.device.type != 'cpu' and \
        not ut._disk_n:
      return super().__getitem__(ids)
    if torch.is_tensor(ids) and ids.device.type != 'cpu':
      ids = ids.cpu()     # the lookup's one host sync
      ut.host_syncs += 1
    ids = torch.as_tensor(np.asarray(ids)).long()
    pad = ids < 0
    idx = ids.clamp(min=0)
    oob = torch.zeros_like(pad)
    if self._id2index is not None:
      remap = torch.as_tensor(self._id2index)
      oob = idx >= remap.shape[0]
      idx = remap[idx.clamp(max=remap.shape[0] - 1)].long()
    idx = torch.where(pad, 0, idx)
    oob = ~pad & (oob | (idx >= self._n))
    rows = ut.gather_host(idx.clamp(0, max(self._n - 1, 0)))
    if bool(oob.any()):
      if rows.device.type == 'cuda':
        oob = oob.pin_memory().to(rows.device, non_blocking=True)
      rows.masked_fill_(oob[:, None], _fill_value(rows.dtype))
    return rows

  def device_table(self):
    """``(hot, id2index)`` on the device when every row is hot, else
    None (the loaders then read through ``__getitem__``)."""
    self.lazy_init()
    if self._unified.host_rows or self._unified.device_part is None:
      return None
    return self._unified.device_part, self._id2index_dev

  def cpu_get(self, ids) -> np.ndarray:
    """Host gather across all three tiers (hot rows from the host copy
    kept for IPC and rebuilds, not from the device)."""
    ids = np.asarray(ids).reshape(-1)
    rows = self._id2index[ids] if self._id2index is not None else ids
    return self._rows_host(np.asarray(rows, np.int64))

  def _rows_host(self, rows: np.ndarray) -> np.ndarray:
    out = np.zeros((rows.shape[0], self._f), self._np_dtype)
    is_hot = rows < self.hot_rows
    if is_hot.any():
      out[is_hot] = self._hot_np[rows[is_hot]]
    rest = ~is_hot
    if rest.any():
      self.lazy_init()
      out[rest] = self._unified._host_resolve(rows[rest] - self.hot_rows)
    return out

  def stage_gather(self, abs_rows: np.ndarray) -> np.ndarray:
    """Warm and disk rows for absolute storage rows ``>= hot_rows``,
    straight from the tiers (no promoted-cache consult, no miss
    accounting): the staging worker's read path."""
    abs_rows = np.asarray(abs_rows, np.int64).reshape(-1)
    if abs_rows.size and abs_rows.min() < self.hot_rows:
      raise IndexError('stage_gather serves the host tiers: rows must '
                       f'be >= hot_rows ({self.hot_rows})')
    out = np.zeros((abs_rows.shape[0], self._f), self._np_dtype)
    rel = abs_rows - self.hot_rows
    is_warm = rel < self.warm_rows
    if is_warm.any():
      out[is_warm] = self._warm_np[rel[is_warm]]
    cold = ~is_warm
    if cold.any():
      out[cold] = self._disk.gather(rel[cold] - self.warm_rows +
                                    self._disk_base)
    return out

  def promote(self, abs_rows_sorted: np.ndarray, rows: np.ndarray):
    """Install already-gathered cold rows into the promoted cache."""
    self._promoted.put(np.asarray(abs_rows_sorted, np.int64),
                       np.asarray(rows))

  def scan_tables(self):
    """``(hot [H, F], id2index)`` on the device: the prefix the tiered
    scanned trainer gathers hot rows from. Needs ``hot_rows >= 1`` (pad
    slots clamp into the hot prefix)."""
    self.lazy_init()
    if self._unified.device_part is None:
      raise ValueError('TieredFeature.scan_tables needs hot_rows >= 1 '
                       '(the scanned chunk clamps pad slots into the hot '
                       'prefix)')
    return self._unified.device_part, self._id2index_dev

  def tier_occupancy(self) -> dict:
    """Row counts per tier plus the promoted-cache fill (the
    ``storage.*`` gauge payload)."""
    return dict(hot=self.hot_rows, warm=self.warm_rows,
                disk=self.disk_rows, promoted=self._promoted.rows)

  # ----------------------------------------------------------------- IPC

  def share_ipc(self):
    """A handle another process rebuilds the store from: the disk tier
    travels as its directory path (its mmaps reopen on the other side),
    the hot and warm blocks as host arrays, with the remap, the dtype
    and the device."""
    return ('tiered', self._disk.dir if self._disk is not None else None,
            self._disk_base, self._hot_np, self._warm_np, self._id2index,
            self.dtype, self.device)

  def __reduce__(self):
    return (TieredFeature.from_ipc_handle, (self.share_ipc(),))

  @classmethod
  def from_ipc_handle(cls, handle):
    tag, disk_dir, disk_base, hot_np, warm_np, id2index, dtype, *rest = \
        handle
    if tag != 'tiered':
      raise ValueError(f'not a TieredFeature handle: {tag!r}')
    disk = DiskTier(disk_dir) if disk_dir is not None else None
    ref = hot_np if hot_np is not None else warm_np
    f = int(ref.shape[1]) if ref is not None else disk.dim
    np_dtype = ref.dtype if ref is not None else disk.dtype
    n = ((hot_np.shape[0] if hot_np is not None else 0) +
         (warm_np.shape[0] if warm_np is not None else 0) +
         (disk.rows - int(disk_base) if disk is not None else 0))
    obj = cls.__new__(cls)
    obj._setup(hot_np, warm_np, disk, disk_base, n, f, np_dtype, id2index,
               dtype, rest[0] if rest else None, 65536)
    return obj
