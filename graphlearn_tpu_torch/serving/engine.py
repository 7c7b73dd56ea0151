"""Online serving endpoint: admission batching into padded buckets.

Counterpart of ``graphlearn_tpu/serving/engine.py`` (``DEFAULT_BUCKETS``,
``_Request``, ``ServingEngine``). Many small concurrent lookups meet a
device that wants few large fixed-shape calls:

- **Admission batching.** Requests enqueue; one dispatcher thread drains
  them into one flat id vector, waiting at most ``max_wait_ms`` past the
  first request for the batch to fill, and draining whatever already
  queued once the window has closed.
- **Padded buckets.** The batch pads to the smallest capacity of a closed
  ``buckets`` set; a batch above the largest splits across it.
- **Staleness and final-layer refresh.** ``mark_stale(ids)`` flags
  nodes; before a stale node is served the engine recomputes only its
  last layer (``EmbeddingMaterializer.refresh_rows``) and writes the
  rows back. A failed refresh keeps the mark.

Only the dispatcher thread touches the device: ``submit`` validates and
enqueues host ids, and each batch ends in one ``store.fetch`` (a
synchronising copy to the host). Metrics go to the port's registry:
``serving.requests`` / ``batches`` / ``refreshed`` counters and the
``serving.queue_wait_ms`` / ``batch_fill`` / ``compute_ms`` /
``total_ms`` histograms. Spans as JAX's: a ``serving.request`` span
opens on the submitting thread (so it joins the caller's trace, the
``serve`` RPC handler's adopted context included) and closes at respond
time, with ``serving.queue`` / ``serving.batch`` / ``serving.compute`` /
``serving.respond`` under it. ``config=`` takes a tune artifact, as
JAX's does: a store whose node count differs from the tuned dataset's
is refused, the artifact's bucket ladder is the default, and its
gather-kernel routing is stamped on the store (``use_pallas_v2``: the
lookups go through the run-segmented gather, K2).
"""
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from .. import metrics
from ..metrics import spans

DEFAULT_BUCKETS = (16, 64, 256)


class _Request:
  __slots__ = ('ids', 'future', 't0', 'span')

  def __init__(self, ids: np.ndarray):
    self.ids = ids
    self.future: Future = Future()
    self.t0 = time.perf_counter()
    # the request span opens on the SUBMITTING thread (so it inherits
    # the caller's trace) but is closed by the dispatcher at respond
    # time: attach=False keeps it off the submitter's context stack
    self.span = spans.begin('serving.request', attach=False,
                            n=int(ids.size))


class ServingEngine:
  """Admission-batched embedding lookup endpoint over an embedding store.

  Args:
    store: an ``EmbeddingStore`` (its device is the engine's).
    buckets: padded capacities (each a multiple of the store's
      ``granularity``); the closed shape set.
    max_wait_ms: admission window past the first queued request.
    refresh_fn: ``ids -> [n, F] rows`` final-layer recompute
      (``EmbeddingMaterializer.refresh_rows``; for a typed materializer
      ``lambda ids: mat.refresh_rows(ids, ntype='paper')``, the store
      holding that type's table) for stale nodes; needs a store with
      ``update_rows``.
    config: a tune artifact (``graphlearn_tpu_torch.tune()``): the
      bucket ladder when ``buckets`` is not given, and its kernel
      routing on the store; a store whose node count drifted from the
      tuned dataset's is refused.
  """

  def __init__(self, store, buckets: Optional[Sequence[int]] = None,
               max_wait_ms: float = 2.0,
               refresh_fn: Optional[Callable] = None, config=None):
    if config is not None:
      tuned_n = (config.dataset or {}).get('num_nodes')
      store_n = getattr(store, 'num_nodes', None)
      if tuned_n is not None and store_n is not None and \
          int(tuned_n) != int(store_n):
        raise ValueError(
            f'ServingEngine config= artifact was tuned for '
            f'{tuned_n} nodes but the store serves {store_n} — '
            'dataset drifted; re-run graphlearn_tpu_torch.tune() '
            f'(artifact fingerprint {config.fingerprint}, '
            'docs/tuning.md)')
      if buckets is None:
        buckets = config.serving_kwargs()['buckets']
      if hasattr(config, 'apply_kernel_routing'):
        # the tuned gather-kernel choice reaches the engine's store;
        # stores without the surface (dist / tiered) do not take it
        config.apply_kernel_routing(store)
    if buckets is None:
      buckets = DEFAULT_BUCKETS
    buckets = tuple(sorted(int(b) for b in set(buckets)))
    if not buckets:
      raise ValueError('at least one bucket capacity is required')
    g = getattr(store, 'granularity', 1)
    for b in buckets:
      if b <= 0 or b % g:
        raise ValueError(
            f'bucket capacity {b} must be a positive multiple of the '
            f'store granularity {g}')
    if refresh_fn is not None and \
        getattr(store, 'update_rows', None) is None:
      raise ValueError('refresh_fn needs a store with update_rows '
                       '(single-replica EmbeddingStore)')
    self.store = store
    self.buckets = buckets
    self.max_wait_s = float(max_wait_ms) / 1e3
    self._refresh_fn = refresh_fn
    self._q: 'queue.Queue[_Request]' = queue.Queue()
    # stale-id set shared between caller threads (mark_stale) and the
    # dispatcher (_refresh_stale); every access holds _stale_lock
    # graftlint: shared[_stale_lock]
    self._stale: set = set()
    self._stale_lock = threading.Lock()
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  # ------------------------------------------------------------ lifecycle

  def start(self):
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop.clear()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name='gtt-serving-dispatcher')
    self._thread.start()
    return self

  def stop(self):
    """Drain-free stop: pending requests get a RuntimeError."""
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=10)
      self._thread = None
    while True:
      try:
        r = self._q.get_nowait()
      except queue.Empty:
        break
      if not r.future.done():
        r.future.set_exception(RuntimeError('serving engine stopped'))

  def __enter__(self):
    return self.start()

  def __exit__(self, *exc):
    self.stop()

  # -------------------------------------------------------------- intake

  def submit(self, ids) -> Future:
    """Enqueue one lookup request (any length). Returns a Future whose
    result is the ``[len(ids), F]`` numpy row block, in request order."""
    if self._thread is None or not self._thread.is_alive():
      raise RuntimeError('serving engine is not started')
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size == 0:
      f = Future()
      f.set_result(np.zeros((0, self.store.feature_dim), np.float32))
      return f
    if ids.min() < 0 or ids.max() >= self.store.num_nodes:
      raise ValueError(
          f'ids must be in [0, {self.store.num_nodes}); padding is an '
          'engine-internal concept and never crosses the API')
    req = _Request(ids)
    self._q.put(req)
    if self._stop.is_set() and not req.future.done():
      # stop() may have drained the queue between the alive check and
      # the put: fail fast instead of leaving the Future to hang
      req.future.set_exception(RuntimeError('serving engine stopped'))
    return req.future

  def lookup(self, ids, timeout: Optional[float] = 30.0) -> np.ndarray:
    """Synchronous convenience: submit + wait."""
    return self.submit(ids).result(timeout)

  def mark_stale(self, ids):
    """Flag nodes whose inputs changed: their next lookup pays one
    final-layer refresh, then serves fresh rows. Needs a ``refresh_fn``:
    without one a mark could never be honoured."""
    if self._refresh_fn is None:
      raise ValueError(
          'mark_stale needs a refresh_fn (ServingEngine(..., '
          'refresh_fn=materializer.refresh_rows)); without one stale '
          'marks would be accepted but never honoured — rematerialize '
          'and rebuild the store instead')
    ids = np.asarray(ids, np.int64).reshape(-1)
    with self._stale_lock:
      self._stale.update(int(i) for i in ids)

  def stale_count(self) -> int:
    with self._stale_lock:
      return len(self._stale)

  # ----------------------------------------------------------- dispatcher

  def _bucket_for(self, n: int) -> int:
    for b in self.buckets:
      if n <= b:
        return b
    return self.buckets[-1]

  def _loop(self):
    while not self._stop.is_set():
      try:
        first = self._q.get(timeout=0.05)
      except queue.Empty:
        continue
      batch = [first]
      fill = first.ids.size
      deadline = first.t0 + self.max_wait_s
      while fill < self.buckets[-1]:
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
          # window closed: still drain whatever already queued (no extra
          # wait), or under sustained load every batch would hold one
          # request
          try:
            r = self._q.get_nowait()
          except queue.Empty:
            break
        else:
          try:
            r = self._q.get(timeout=remaining)
          except queue.Empty:
            break
        batch.append(r)
        fill += r.ids.size
      try:
        self._serve_batch(batch)
      except BaseException as e:  # noqa: BLE001 — the futures carry it
        for r in batch:
          if not r.future.done():
            r.future.set_exception(e)

  def _refresh_stale(self, flat: np.ndarray):
    if self._refresh_fn is None:
      return
    with self._stale_lock:
      if not self._stale:
        return
      stale_now = sorted(set(int(i) for i in flat) & self._stale)
      if not stale_now:
        return
      # claimed under the lock: concurrent batches refresh a node once
      self._stale.difference_update(stale_now)
    try:
      ids = np.asarray(stale_now, np.int64)
      rows = self._refresh_fn(ids)
      self.store.update_rows(ids, rows)
    except BaseException:
      # a failed refresh keeps the marks: a retry must not be served the
      # old rows as if fresh
      with self._stale_lock:
        self._stale.update(stale_now)
      raise
    metrics.inc('serving.refreshed', len(stale_now))

  def _serve_batch(self, batch):
    # drop requests already failed elsewhere (a submit that lost the
    # stop() race)
    batch = [r for r in batch if not r.future.done()]
    if not batch:
      return
    t_batch = time.perf_counter()
    t_batch_unix = time.time()
    for r in batch:
      wait = t_batch - r.t0
      metrics.observe('serving.queue_wait_ms', wait * 1e3)
      # retroactive queue span: measured as plain timestamps at pickup
      spans.emit('serving.queue', trace=r.span.trace,
                 parent=r.span.span_id, t0_unix=t_batch_unix - wait,
                 dur_ms=wait * 1e3)
    # one batch span per admission batch, under the FIRST request's span;
    # the other requests name it in their request span's batch attr
    flat = np.concatenate([r.ids for r in batch])
    batch_span = spans.begin('serving.batch', attach=False,
                             trace=batch[0].span.trace,
                             parent=batch[0].span.span_id,
                             requests=len(batch))
    try:
      self._refresh_stale(flat)
      outs = []
      pos = 0
      while pos < flat.size:
        take = min(flat.size - pos, self.buckets[-1])
        cap = self._bucket_for(take)
        padded = np.full((cap,), -1, np.int32)
        padded[:take] = flat[pos:pos + take]
        mask = padded >= 0
        metrics.observe('serving.batch_fill', take / cap)
        rows = self.store.fetch(self.store.lookup(padded, mask))
        outs.append(rows[:take])
        metrics.inc('serving.batches')
        pos += take
      rows_all = outs[0] if len(outs) == 1 else np.concatenate(outs)
      compute_s = time.perf_counter() - t_batch
      metrics.observe('serving.compute_ms', compute_s * 1e3)
      spans.emit('serving.compute', trace=batch_span.trace,
                 parent=batch_span.span_id, t0_unix=t_batch_unix,
                 dur_ms=compute_s * 1e3, ids=int(flat.size))
    finally:
      # a raising refresh / fetch must not strand the batch span open
      spans.end(batch_span, fill=int(flat.size))
    o = 0
    for r in batch:
      res = rows_all[o:o + r.ids.size]
      o += r.ids.size
      # metrics before set_result: a caller reading counters right after
      # .result() returns sees its own request counted
      metrics.inc('serving.requests')
      metrics.observe('serving.total_ms',
                      (time.perf_counter() - r.t0) * 1e3)
      t_resp = time.perf_counter()
      if not r.future.done():   # lost a stop() race: already failed
        r.future.set_result(res)
      spans.emit('serving.respond', trace=r.span.trace,
                 parent=r.span.span_id,
                 dur_ms=(time.perf_counter() - t_resp) * 1e3)
      # the request span's duration is the request's enqueue-to-rows
      # latency
      spans.end(r.span, batch=batch_span.span_id)

  def serve_numpy(self, ids) -> np.ndarray:
    """Synchronous host entry (the JAX package's ``serve`` RPC handler
    calls this): submit through the same admission queue, block for the
    rows."""
    return self.lookup(np.asarray(ids, np.int64))
