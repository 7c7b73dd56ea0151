"""Chunk-boundary staging: disk and host RAM -> a ring of host slabs.

Counterpart of ``graphlearn_tpu/storage/staging.py``. The whole epoch's
miss set is known at the prologue (``storage/planner.py``), so while
chunk ``c`` trains on the device one bounded worker thread gathers chunk
``c+1``'s warm and disk rows into a host slab, pow2-padded, and hands it
to the dispatch thread at the chunk boundary.

On a card the ring's slabs are pinned host tensors, one slot per chunk
in flight (``max_ahead + 1`` slots, chunk ``c`` in slot ``c % (max_ahead
+ 1)``). The trainer copies a slab to the device without blocking the
host and acks the chunk with the event it recorded after that copy; the
slot goes back to the worker only once that event has completed, so the
worker never overwrites a slab that is still being copied. (JAX acks
right after its ``device_put``, which has already copied the slab.) The
worker waits for a release by polling the event, never by a host sync of
the dispatch thread's stream. On the CPU a slab's copy ends before the
ack returns, and the slot is free at once.

Failure semantics, as in JAX: a failed or slow worker never yields a
wrong batch. :meth:`ChunkStager.take` falls back to a synchronous gather
of the same planned rows (counted by ``storage.prefetch_miss``), so the
degraded epoch is bit-identical to the healthy one, only slower.
``_stage_fault`` is the worker's fault site (``storage.stage``; the
distributed stager's is ``storage.dist_stage``), overridden by tests.

Metrics, JAX's names: ``storage.staged_rows`` / ``storage.staged_bytes``
counters, ``storage.stage_ms`` / ``storage.promote_ms`` histograms and
the ``storage.ring_rows`` gauge, and one ``storage.stage`` span per staged
chunk on the worker thread.
"""
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import metrics
from ..metrics import spans
from ..utils.faults import fault_point

INT32_MAX = np.iinfo(np.int32).max

# how long the worker sleeps between polls of a slot's release event
_POLL_S = 0.0002


def pow2_slab_cap(n: int) -> int:
  """Padded slab capacity: next power of two, floor 1 (one captured
  shape per capacity)."""
  if n <= 1:
    return 1
  return 1 << int(n - 1).bit_length()


def pad_slab(row_ids: np.ndarray, rows: np.ndarray):
  """(ids [cap], rows [cap, F]) pow2-padded; pad id slots carry
  INT32_MAX so a searchsorted of storage rows can never match them."""
  n = int(row_ids.shape[0])
  cap = pow2_slab_cap(n)
  ids = np.full((cap,), INT32_MAX, np.int32)
  ids[:n] = row_ids
  out = np.zeros((cap,) + rows.shape[1:], rows.dtype)
  out[:n] = rows
  return ids, out


class _Slab:
  """One planned chunk's staging record."""
  __slots__ = ('ids', 'rows', 'ready', 'error', 't_done', 'stage_ms')

  def __init__(self):
    self.ids = None
    self.rows = None
    self.ready = threading.Event()
    self.error: Optional[BaseException] = None
    self.t_done: Optional[float] = None
    self.stage_ms: Optional[float] = None


class _Slot:
  """A ring slot: host buffers (pinned on a card) the worker writes a
  chunk's slab into, and the event after which the last chunk's copy
  out of it has completed."""
  __slots__ = ('ids', 'rows', 'chunk', 'release', 'cap')

  def __init__(self, cap: int, dim: int, dtype, pin: bool):
    self.cap = cap
    self.ids = torch.empty((cap,), dtype=torch.int32, pin_memory=pin)
    self.rows = torch.empty((cap, dim), dtype=dtype, pin_memory=pin)
    self.chunk = None      # chunk whose slab the slot holds (None: free)
    self.release = None    # CUDA event of that chunk's copy, at its ack

  @property
  def nbytes(self) -> int:
    return (self.ids.numel() * self.ids.element_size() +
            self.rows.numel() * self.rows.element_size())


class ChunkStager:
  """One background worker staging planned chunk slabs ahead of the
  dispatch loop.

  Args:
    store: the ``TieredFeature`` whose warm and disk tiers to read
      (``store.stage_gather(abs_rows)``).
    max_ahead: staged chunks in flight (2 = double buffer: slab c+1
      fills while chunk c trains).
    timeout_s: how long :meth:`take` waits for the worker before
      degrading to a synchronous gather.
  """

  def __init__(self, store, max_ahead: int = 2, timeout_s: float = 30.0):
    if max_ahead < 1:
      raise ValueError('max_ahead must be >= 1')
    self.store = store
    self.max_ahead = int(max_ahead)
    self.timeout_s = float(timeout_s)
    self._pin = torch.device(store.device).type == 'cuda'
    self._lock = threading.Lock()
    # ring state shared between the dispatch thread (begin_epoch / take /
    # ack) and the worker (_loop): every access holds _lock
    # graftlint: shared[_lock]
    self._plan: List[np.ndarray] = []
    # graftlint: shared[_lock]
    self._slabs: Dict[int, _Slab] = {}
    self._slots: List[_Slot] = []
    # graftlint: shared[_lock]
    self._next_submit = 0
    self._gen = 0          # epoch generation: the queue's stale ids skip
    self._q: 'queue.Queue' = queue.Queue()
    self._worker: Optional[threading.Thread] = None
    self._stop = False
    self.degraded = False   # a worker gather failed or timed out
    # perf_counter marks per chunk, kept for the whole epoch (the
    # chunk-boundary overlap contract is asserted from these)
    self.stage_done_t: Dict[int, float] = {}
    self.ack_t: Dict[int, float] = {}
    # per chunk: the worker's gather ms, and how long take() waited
    self.stage_ms: Dict[int, float] = {}
    self.wait_ms: Dict[int, float] = {}
    # per refill of a slot: (chunk, the previous occupant's release event
    # had completed) -- True by construction
    self.refills: List[tuple] = []

  # ------------------------------------------------------------ lifecycle

  def begin_epoch(self, chunk_rows: List[np.ndarray],
                  start_chunk: int = 0):
    """Install this epoch's plan (per-chunk sorted absolute storage rows
    beyond the hot tier) and prime the first ``max_ahead`` slabs. A
    previous epoch's outstanding slabs are dropped; a resume passes
    ``start_chunk`` (the plan keeps its absolute chunk indexing, earlier
    chunks are never staged again). The ring's slots are sized for the
    plan's largest slab here, before the worker may write one."""
    if not 0 <= start_chunk <= len(chunk_rows):
      raise ValueError(f'start_chunk={start_chunk} outside the '
                       f'{len(chunk_rows)}-chunk plan')
    cap = self._ring_cap(chunk_rows)
    with self._lock:
      self._plan = list(chunk_rows)
      self._slabs = {}
      self._gen += 1
      self._next_submit = int(start_chunk)
      self.degraded = False
      self.stage_done_t, self.ack_t = {}, {}
      self.stage_ms, self.wait_ms = {}, {}
      self.refills = []
      if not self._slots or self._slots[0].cap < cap:
        # the old slots stay alive while the worker or a copy holds them
        # (a pinned block is reused only after its copies' events)
        self._slots = [self._new_slot(cap)
                       for _ in range(self.max_ahead + 1)]
      else:
        for s in self._slots:
          s.chunk = None     # an earlier epoch's chunks are all acked
    self._ensure_worker()
    for _ in range(min(self.max_ahead, len(chunk_rows) - int(start_chunk))):
      self._submit_next()

  def _row_dtype(self):
    return torch.from_numpy(np.zeros((0,), self.store._np_dtype)).dtype

  def _ring_cap(self, chunk_rows) -> int:
    """The slab capacity the ring's slots are sized for: the plan's
    largest pow2 chunk."""
    return max([pow2_slab_cap(int(r.shape[0])) for r in chunk_rows] or [1])

  def _new_slot(self, cap: int) -> '_Slot':
    return _Slot(cap, self.store.shape[1], self._row_dtype(), self._pin)

  @property
  def ring_bytes(self) -> int:
    """Host bytes the ring's slots hold (pinned on a card)."""
    with self._lock:
      return sum(s.nbytes for s in self._slots)

  def watermarks(self) -> Dict[str, int]:
    """Ring position for checkpoint metadata: the next chunk the worker
    will be asked to stage and the slabs currently held."""
    with self._lock:
      return dict(next_submit=int(self._next_submit),
                  held=len(self._slabs), planned=len(self._plan))

  def close(self):
    self._stop = True
    self._q.put(None)
    w = self._worker
    if w is not None:
      w.join(timeout=5.0)
    self._worker = None
    self._stop = False
    # drain what the stopped worker left behind (queued chunk ids, or
    # the None sentinel itself): a stale None would end the next
    # epoch's fresh worker on its first pop
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass

  def _ensure_worker(self):
    if self._worker is not None and self._worker.is_alive():
      return
    self._worker = threading.Thread(target=self._loop, daemon=True,
                                    name='gtt-storage-stager')
    self._worker.start()

  def _submit_next(self):
    with self._lock:
      c = self._next_submit
      if c >= len(self._plan):
        return
      self._next_submit = c + 1
      self._slabs[c] = _Slab()
      gen = self._gen
    self._q.put((gen, c))

  # --------------------------------------------------------------- worker

  def _loop(self):
    while True:
      item = self._q.get()
      if item is None or self._stop:
        return
      gen, c = item
      with self._lock:
        if gen != self._gen:
          continue   # queued by an earlier epoch
        slab = self._slabs.get(c)
        rows_abs = self._plan[c] if c < len(self._plan) else None
        slot = self._slots[c % len(self._slots)] if self._slots else None
      if slab is None or rows_abs is None:
        continue   # the epoch moved on
      try:
        self._stage_fault()
        claimed = self._claim(slot, c, slab)
        if claimed is None:
          continue   # acked (a degraded take) before its slot came free
        if not claimed:
          return     # closed while waiting for the slot
        t0 = time.perf_counter()
        with spans.span('storage.stage', chunk=int(c),
                        rows=int(rows_abs.shape[0])):
          ids, rows = self._gather_into(rows_abs, slot)
        with self._lock:
          if self._slabs.get(c) is not slab:
            slot.chunk = None   # acked while staging: nothing reads it
        ms = (time.perf_counter() - t0) * 1e3
        metrics.observe('storage.stage_ms', ms)
        t1 = time.perf_counter()
        fault_point('storage.promote')
        slab.ids, slab.rows = ids, rows
        slab.stage_ms = ms
        metrics.inc('storage.staged_rows', int(rows_abs.shape[0]))
        metrics.inc('storage.staged_bytes', int(rows.numel() *
                                                rows.element_size()))
        metrics.observe('storage.promote_ms',
                        (time.perf_counter() - t1) * 1e3)
        metrics.set_gauge('storage.ring_rows', self._ring_rows())
      except Exception as e:   # noqa: BLE001 -- degrade, never kill later chunks
        slab.error = e
        self.degraded = True
      finally:
        slab.t_done = time.perf_counter()
        with self._lock:
          self.stage_done_t[c] = slab.t_done
          if slab.stage_ms is not None:
            self.stage_ms[c] = slab.stage_ms
        slab.ready.set()

  def _claim(self, slot: _Slot, c: int, slab: _Slab) -> Optional[bool]:
    """Wait until ``slot`` is free (its last chunk acked and that chunk's
    copy event completed) and take it for chunk ``c``. Returns False if
    the stager closed, None if ``c`` was acked meanwhile."""
    while True:
      with self._lock:
        if self._slabs.get(c) is not slab:
          return None
        free = slot.chunk is None
        ev = slot.release
      if free and (ev is None or ev.query()):
        with self._lock:
          self.refills.append((c, ev is None or ev.query()))
          slot.chunk, slot.release = c, None
        return True
      if self._stop:
        return False
      time.sleep(_POLL_S)

  def _stage_fault(self):
    """The worker's fault site, ``storage.stage`` (tests also override
    it). It runs in the worker only, never in :meth:`take`'s synchronous
    fallback, so the degraded path gathers the same planned rows
    cleanly."""
    fault_point('storage.stage')

  def _gather_into(self, rows_abs: np.ndarray, slot: _Slot):
    """Gather the planned rows into ``slot``, pow2-padded as
    :func:`pad_slab`: ``(ids [cap], rows [cap, F])`` views of the slot."""
    rows = self.store.stage_gather(rows_abs)
    n = int(rows_abs.shape[0])
    cap = pow2_slab_cap(n)
    ids_np = slot.ids.numpy()
    ids_np[:n] = rows_abs
    ids_np[n:cap] = INT32_MAX
    rows_np = slot.rows.numpy()
    rows_np[:n] = rows
    rows_np[n:cap] = 0
    return slot.ids[:cap], slot.rows[:cap]

  def _gather(self, rows_abs: np.ndarray):
    """The synchronous gather of the degraded path: a fresh slab (pinned
    on a card), the same bytes as the worker's."""
    ids, rows = pad_slab(rows_abs.astype(np.int32),
                         self.store.stage_gather(rows_abs))
    ids, rows = torch.from_numpy(ids), torch.from_numpy(rows)
    if self._pin:
      ids, rows = ids.pin_memory(), rows.pin_memory()
    return ids, rows

  def _ring_rows(self) -> int:
    with self._lock:
      return sum(s.rows.shape[0] for s in self._slabs.values()
                 if s.rows is not None)

  # ------------------------------------------------------------- consumer

  def take(self, c: int):
    """Slab for chunk ``c``: ``(ids [cap] int32 sorted + INT32_MAX pads,
    rows [cap, F])``, CPU tensors (pinned on a card). Blocks up to
    ``timeout_s`` for the worker, then degrades to a synchronous gather of
    the same planned rows (counted in ``storage.prefetch_miss``): the same
    bytes either way. Also submits the next chunk so the pipeline stays
    ``max_ahead`` deep. The slab is valid until :meth:`ack`."""
    t0 = time.perf_counter()
    with self._lock:
      slab = self._slabs.get(c)
      rows_abs = self._plan[c]
    ok = slab is not None and slab.ready.wait(self.timeout_s)
    with self._lock:
      self.wait_ms[c] = (time.perf_counter() - t0) * 1e3
    self._submit_next()
    if ok and slab.error is None and slab.ids is not None:
      return slab.ids, slab.rows
    # the worker failed, faulted or is too slow: gather the same planned
    # rows here. Never a wrong batch, only a slower one.
    self.degraded = True
    metrics.inc('storage.prefetch_miss', int(rows_abs.shape[0]))
    return self._gather(rows_abs)

  def ack(self, c: int, event=None):
    """Chunk ``c`` is done with its slab: free its ring slot. With
    ``event`` (a CUDA event recorded after the slab's copy to the
    device) the slot is handed back only once the event has completed."""
    with self._lock:
      self._slabs.pop(c, None)
      self.ack_t[c] = time.perf_counter()
      if self._slots:
        slot = self._slots[c % len(self._slots)]
        if slot.chunk == c:
          slot.chunk, slot.release = None, event
    metrics.set_gauge('storage.ring_rows', self._ring_rows())
