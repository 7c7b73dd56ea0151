"""Zero-downtime rotating sharded serving stores.

Counterpart of ``graphlearn_tpu/serving/rotation.py``. A multi-shard
store whose next version is spilled to per-shard disk tiers while the
current version keeps serving, then swapped in atomically, under live
traffic, keeping the previous version when a shard swap fails.

Version lifecycle:

  1. **Build, concurrent with serving.** ``rotate(build_fn)`` produces
     the next version's ``[N, F]`` table (typically
     ``EmbeddingMaterializer.materialize()``) and spills it as per-shard
     memory-mapped disk tiers under ``<root>/v<NNNN>/shard_<SS>``
     (``storage.spill_array``). Nothing the build does is visible to
     readers.
  2. **Swap.** Each shard's new payload is installed in a per-shard pass
     (``_rotate_fault`` runs per shard: JAX's ``serving.rotate`` fault
     site), then one atomic pointer flip publishes the version: a
     lookup reads the shard tuple exactly once, so every request is
     answered from a single version. The flip's duration is the
     ``serving.rotation_swap_ms`` histogram.
  3. **Degrade.** A failed shard swap (or build) discards the partial
     version and keeps the previous one serving. Disk retention is one
     rotation deep: after a flip to v, version directories older than
     v - 1 are pruned; a reader's snapshot keeps its shards' mmaps alive.

A shard keeps its first ``warm_rows`` rows in host memory and serves the
rest from its disk tier; a lookup gathers on the host and returns the
rows on the store's device (the card unless the caller asks for the
CPU), pad slots zeroed: the engine-facing store contract
(``lookup`` / ``fetch`` / ``num_nodes`` / ``granularity``).
:class:`RotationScheduler` drives rotations on an interval or a
staleness trigger. Each swap is one ``serving.rotate`` span.
"""
import os
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

import torch

from .. import metrics
from ..metrics import spans
from ..storage.disk import spill_array
from ..utils import resolve_device
from ..utils.faults import fault_point
from ..utils.trace import record_dispatch


def _host(table) -> np.ndarray:
  """A version table on the host (a tensor from any device, or an
  array)."""
  if isinstance(table, torch.Tensor):
    return table.detach().cpu().numpy()
  return np.asarray(table)


class _VersionShard:
  """One shard of one store version: rows [lo, hi) of the version's
  table, a warm RAM prefix + the spilled mmap tier."""

  __slots__ = ('lo', 'hi', 'tier', 'warm')

  def __init__(self, lo: int, hi: int, tier, warm_rows: int):
    self.lo, self.hi = int(lo), int(hi)
    self.tier = tier
    w = max(0, min(int(warm_rows), tier.rows))
    self.warm = (tier.gather(np.arange(w, dtype=np.int64)) if w
                 else None)

  def gather(self, local_ids: np.ndarray) -> np.ndarray:
    out = np.zeros((local_ids.shape[0], self.tier.dim), self.tier.dtype)
    w = 0 if self.warm is None else self.warm.shape[0]
    is_warm = local_ids < w
    if is_warm.any():
      out[is_warm] = self.warm[local_ids[is_warm]]
    cold = ~is_warm
    if cold.any():
      out[cold] = self.tier.gather(local_ids[cold])
    return out


class RotatingShardedStore:
  """Sharded, versioned embedding store with zero-downtime rotation.

  Args:
    root_dir: where per-version per-shard tiers are spilled
      (``<root>/v<NNNN>/shard_<SS>``).
    num_shards: contiguous row shards per version.
    initial_table: version 0's [N(, _pad), F] table (np array or
      device array; rows past ``num_nodes`` are trimmed).
    num_nodes: REAL node count (materializer tables carry block-pad
      rows; they must stay behind the engine's id validation — the
      ``EmbeddingMaterializer.embedding_store`` footgun).
    warm_rows: per-shard host-RAM prefix; the rest of each shard
      serves from its memory-mapped tier.
    rows_per_chunk: DiskTier layout knob for the spills.
    device: where lookups return their rows (None: the card).
  """

  granularity = 1

  def __init__(self, root_dir: str, num_shards: int, initial_table,
               num_nodes: Optional[int] = None, warm_rows: int = 0,
               rows_per_chunk: int = 65536, device=None):
    if num_shards < 1:
      raise ValueError('num_shards must be >= 1')
    self.device = resolve_device(device)
    table = _host(initial_table)
    self.root_dir = str(root_dir)
    self.num_shards = int(num_shards)
    self.num_nodes = int(num_nodes if num_nodes is not None
                         else table.shape[0])
    if self.num_nodes > table.shape[0]:
      raise ValueError(f'num_nodes={self.num_nodes} exceeds the table '
                       f'height {table.shape[0]}')
    self._fdim = int(table.shape[1])
    self.warm_rows = int(warm_rows)
    self.rows_per_chunk = int(rows_per_chunk)
    # shard s covers rows [bounds[s], bounds[s+1])
    self._bounds = (np.arange(self.num_shards + 1, dtype=np.int64)
                    * self.num_nodes) // self.num_shards
    self._version = -1
    self._shards: Optional[Tuple[_VersionShard, ...]] = None
    self._rotate_lock = threading.Lock()   # one rotation at a time
    self.install_version(table)

  # ------------------------------------------------------------ rotation

  @property
  def version(self) -> int:
    """The currently served version index."""
    return self._version

  def install_version(self, table) -> int:
    """Build the next version from ``table`` and swap it in (module
    docstring: build concurrent with serving, one atomic flip, degrade
    to the previous version on any failure). Returns the new version
    index; raises the build/swap failure AFTER guaranteeing the
    previous version still serves."""
    table = _host(table)
    if table.shape[0] < self.num_nodes or table.shape[1] != self._fdim:
      raise ValueError(
          f'version table must be [>= {self.num_nodes}, {self._fdim}], '
          f'got {table.shape}')
    with self._rotate_lock:
      v = self._version + 1
      # BUILD: per-shard disk tiers — invisible to readers until the
      # flip below, so a failure here leaves the serving version
      # untouched by construction
      built = []
      for s in range(self.num_shards):
        lo, hi = int(self._bounds[s]), int(self._bounds[s + 1])
        tier = spill_array(
            os.path.join(self.root_dir, f'v{v:04d}', f'shard_{s:02d}'),
            table[lo:hi], rows_per_chunk=self.rows_per_chunk)
        built.append((lo, hi, tier))
      # SWAP: the per-shard install pass + one atomic pointer flip.
      # A fault mid-pass abandons the staged list — the previous
      # version keeps serving, zero failed requests (chaos-tested)
      t0 = time.perf_counter()
      with spans.span('serving.rotate', version=v,
                      shards=self.num_shards):
        staged = []
        for lo, hi, tier in built:
          self._rotate_fault()
          staged.append(_VersionShard(lo, hi, tier, self.warm_rows))
        # the one flip readers snapshot: a tuple assignment is atomic,
        # and every lookup reads self._shards exactly once. No
        # previous-version bookkeeping is needed: a reader's snapshot
        # keeps its shard tuple (and mmaps) alive by reference
        self._shards = tuple(staged)
        self._version = v
      metrics.inc('serving.rotations')
      metrics.observe('serving.rotation_swap_ms',
                      (time.perf_counter() - t0) * 1e3)
      self._prune_versions(v - 1)
      return v

  def _rotate_fault(self):
    """The per-shard swap's fault seam: JAX's ``serving.rotate`` site
    (``utils.faults``), which a subclass may also override."""
    fault_point('serving.rotate')

  def _prune_versions(self, keep_from: int):
    """Delete spilled version dirs older than ``keep_from`` — the
    one-rotation-deep disk retention (a long-running rotation loop
    writes a full table copy per version; without pruning the root
    dir grows without bound). Readers mid-request are safe: their
    snapshot's mmap handles keep unlinked pages valid until dropped.
    Best-effort — a prune failure must never fail a completed swap."""
    import re
    import shutil
    try:
      names = os.listdir(self.root_dir)
    except OSError:
      return
    for d in names:
      m = re.match(r'^v(\d+)$', d)
      if m and int(m.group(1)) < keep_from:
        shutil.rmtree(os.path.join(self.root_dir, d),
                      ignore_errors=True)

  def rotate(self, build_fn: Callable[[], np.ndarray]) -> int:
    """One full rotation: materialize the next version while the
    current serves (``build_fn()`` — e.g. ``lambda:
    np.asarray(EmbeddingMaterializer(...).materialize())``), then
    install it. Returns the new version index."""
    return self.install_version(build_fn())

  # ------------------------------------------------------- store surface

  @property
  def feature_dim(self) -> int:
    return self._fdim

  def lookup(self, ids, mask) -> torch.Tensor:
    """``[cap]`` padded ids (-1 pads, mask False) -> ``[cap, F]`` rows on
    the store's device. The shard tuple is read once, so the whole
    request answers from a single version even while a rotation swaps
    underneath."""
    shards = self._shards          # the one consistent-version snapshot
    record_dispatch('serve_lookup')
    ids_np = np.asarray(ids, np.int64).reshape(-1)
    mask_np = np.asarray(mask, bool).reshape(-1)
    rows = np.zeros((ids_np.shape[0], self._fdim), shards[0].tier.dtype)
    safe = np.clip(ids_np, 0, self.num_nodes - 1)
    for sh in shards:
      m = mask_np & (safe >= sh.lo) & (safe < sh.hi)
      if m.any():
        rows[m] = sh.gather(safe[m] - sh.lo)
    out = torch.from_numpy(rows)
    if self.device.type == 'cuda':
      out = out.pin_memory().to(self.device, non_blocking=True)
    return out

  def fetch(self, rows) -> np.ndarray:
    return rows.cpu().numpy()

  def update_rows(self, ids, rows):
    raise NotImplementedError(
        'RotatingShardedStore rows are immutable within a version — '
        'refresh by rotating in the next materialized version (rotate())')


class RotationScheduler:
  """Drives ``RotatingShardedStore.rotate`` on a schedule: the
  materializer loop that turns the zero-downtime swap into a refresh
  cadence.

  A daemon thread polls every ``poll_s`` seconds and triggers one full
  rotation (``build_fn`` -> ``install_version``) when EITHER fires:

  * **interval**: ``interval_s`` seconds elapsed since the last
    successful rotation (wall-clock freshness floor), or
  * **staleness**: ``staleness_fn()`` returned truthy — the
    workload-aware trigger (typical: a closure over the engine's
    stale set or an ingestion watermark; the scheduler imposes no
    schema on it).

  Failure semantics match the store's: a failed build or swap keeps
  the previous version serving (``serving.rotation_errors`` counts it,
  the next poll retries). A ``staleness_fn`` that raises counts as
  not-stale: observability hooks must never take the serving path
  down.

  ``stop()`` is join-semantics: the thread exits its current poll (or
  finishes an in-flight rotation — rotations are never interrupted
  mid-swap) and joins within ``stop(timeout)``.
  """

  def __init__(self, store, build_fn: Callable[[], np.ndarray],
               interval_s: Optional[float] = None,
               staleness_fn: Optional[Callable[[], bool]] = None,
               poll_s: float = 0.5):
    if interval_s is None and staleness_fn is None:
      raise ValueError('RotationScheduler needs a trigger: interval_s '
                       'and/or staleness_fn')
    if interval_s is not None and interval_s <= 0:
      raise ValueError(f'interval_s must be > 0, got {interval_s}')
    self.store = store
    self.build_fn = build_fn
    self.interval_s = None if interval_s is None else float(interval_s)
    self.staleness_fn = staleness_fn
    self.poll_s = float(poll_s)
    self.rotations = 0         # successful rotations this scheduler ran
    self.failures = 0          # failed attempts (previous version kept)
    self.last_error: Optional[str] = None
    self._last_rotate = time.monotonic()
    self._stop = threading.Event()
    self._wake = threading.Event()   # stop/rotate_now interrupt a poll
    self._thread: Optional[threading.Thread] = None

  # ------------------------------------------------------------ lifecycle

  def start(self) -> 'RotationScheduler':
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop.clear()
    # the interval clock runs from START, not construction — a
    # scheduler built during process setup and started after warmup
    # must not fire a full build+swap on its first poll
    self._last_rotate = time.monotonic()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name='gtt-rotation-scheduler')
    self._thread.start()
    return self

  def stop(self, timeout: float = 30.0):
    """Signal the loop to exit and join it. An in-flight rotation
    completes first — the swap critical section is never abandoned
    half-installed (the store's atomicity contract)."""
    self._stop.set()
    self._wake.set()
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)
      if t.is_alive():
        raise TimeoutError(
            f'rotation scheduler did not stop within {timeout}s (a '
            'rotation build is still running; it will finish on the '
            'daemon thread)')
    self._thread = None

  def rotate_now(self):
    """Force the next poll to rotate regardless of triggers."""
    self._force = True
    self._wake.set()

  _force = False

  # ----------------------------------------------------------------- loop

  def _due(self) -> bool:
    if self._force:
      return True
    if self.interval_s is not None and \
        time.monotonic() - self._last_rotate >= self.interval_s:
      return True
    if self.staleness_fn is not None:
      try:
        return bool(self.staleness_fn())
      except Exception:  # noqa: BLE001 - a broken probe must not kill serving
        metrics.inc('serving.rotation_errors')
        import logging
        logging.getLogger('graphlearn_tpu_torch.serving').exception(
            'rotation staleness_fn raised — treating as not-stale')
    return False

  def _loop(self):
    while not self._stop.is_set():
      if self._due():
        try:
          self.store.rotate(self.build_fn)
          # a forced request is consumed only by a SUCCESSFUL rotation
          # — a failed build keeps the force armed so the next poll
          # retries it (the docstring's retry contract holds even for
          # staleness-only schedulers whose probe reads False)
          self._force = False
          self.rotations += 1
          self.last_error = None
          # interval restarts from the SUCCESS; a failure below keeps
          # the old deadline so the next poll retries immediately
          self._last_rotate = time.monotonic()
        except Exception as e:  # noqa: BLE001 - degrade, keep serving
          self.failures += 1
          self.last_error = f'{type(e).__name__}: {e}'
          metrics.inc('serving.rotation_errors')
          import logging
          logging.getLogger('graphlearn_tpu_torch.serving').warning(
              'scheduled rotation failed (%s) — previous version '
              'keeps serving; retrying next poll', self.last_error)
      self._wake.wait(self.poll_s)
      self._wake.clear()
