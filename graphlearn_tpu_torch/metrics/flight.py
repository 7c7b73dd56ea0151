"""Epoch flight recorder: one structured JSONL record per epoch.

Long production runs degrade in ways a final loss curve hides — a
failover absorbed mid-epoch, a feature cache slowly losing its hit
rate, a dispatch count creeping up after a refactor. The flight
recorder writes ONE JSON line per epoch to the file named by the
``GLT_RUN_LOG`` environment variable so a finished (or crashed) run
can be diffed epoch-by-epoch after the fact. The port's copy of
``graphlearn_tpu/metrics/flight.py``: the same record schema, field for
field, under the same ``GLT_RUN_LOG``.

Emitters: the chunked trainers (``ScanTrainer``, ``RunTrainer``,
``TieredScanTrainer``, ``DistScanTrainer``, ``TieredDistScanTrainer``,
``RemoteScanTrainer``), ``OverlappedTrainer``, the per-step loader
loops (``NodeLoader`` / ``DistLoader`` / remote / mp ``__iter__``) and
``EmbeddingMaterializer``. Every record carries DELTAS over the epoch —
metric counters, per-site dispatch counts (a dispatch is one graph
replay or one eager call at a site, ``utils.trace``), per-site captures
(``programs``) — plus wall time, a config fingerprint, and the
device-trace directory (GLT_PROFILE_DIR) when a trace is being captured.

Hot-path contract: :func:`epoch_begin` and :func:`epoch_end` touch
ONLY host state (the metric registry, the active DispatchCounter, the
clock) — zero device->host syncs and zero extra kernel launches, and
neither ever runs inside a CUDA graph capture.
The feature fields bit-match the live ``dist_feature.*`` counters
because emitters call :func:`epoch_end` AFTER the loader's existing
once-per-epoch ``publish_stats`` fetch, never by fetching anything
themselves. When ``GLT_RUN_LOG`` is unset, ``epoch_begin`` returns
None and both calls are a single falsy check.
"""
import hashlib
import json
import logging
import os
import threading
import time
from typing import Optional

ENV_VAR = 'GLT_RUN_LOG'
SCHEMA = 1

logger = logging.getLogger('graphlearn_tpu_torch.flight')
_warned_paths = set()   # one write-failure warning per path, not per epoch


class JsonlAppender:
  """Append JSON records to a JSONL trail, tolerating an unwritable
  path with ONE warning (records are then dropped — observability must
  never kill work). Shared by the flight and span recorders.

  ``keep_open=True`` holds a flushed append handle between records —
  the span recorder emits per-RPC/per-request, where a fresh
  open/close per record would tax the very latencies being measured.
  The flight recorder writes once per epoch and keeps the default
  (per-record open), preserving recreate-the-file-under-it semantics.
  A path change (tests pointing the env var at a fresh tmp dir)
  reopens transparently."""

  def __init__(self, env_var: str, keep_open: bool = False):
    self._env_var = env_var
    self._keep_open = keep_open
    self._lock = threading.Lock()
    # keep-open file handle shared by every thread that appends a
    # record — open/write/reset all hold _lock
    # graftlint: shared[_lock]
    self._path: Optional[str] = None
    # graftlint: shared[_lock]
    self._fh = None

  def append(self, path: str, rec: dict) -> bool:
    line = json.dumps(rec, sort_keys=True) + '\n'
    try:
      with self._lock:
        if not self._keep_open:
          with open(path, 'a', encoding='utf-8') as fh:
            fh.write(line)
          return True
        if self._fh is None or self._path != path:
          if self._fh is not None:
            try:
              self._fh.close()
            except OSError:
              pass
          self._fh = open(path, 'a', encoding='utf-8')
          self._path = path
        self._fh.write(line)
        self._fh.flush()   # readers (tests, tail -f) see records live
      return True
    except OSError as e:
      with self._lock:
        self._fh = None
        self._path = None
      if path not in _warned_paths:
        _warned_paths.add(path)
        logger.warning('%s=%s is unwritable (%s) — records for this '
                       'path are being dropped', self._env_var, path, e)
      return False


def read_jsonl(path: Optional[str],
               kind: Optional[str] = None) -> list:
  """Parse a JSONL trail back into record dicts, optionally filtered
  by their ``kind`` field. Unparseable lines are skipped — a run
  killed mid-write must not take the rest of the log with it. Shared
  by flight.read_records and spans.read_log."""
  if not path or not os.path.exists(path):
    return []
  out = []
  with open(path, encoding='utf-8') as fh:
    for line in fh:
      line = line.strip()
      if not line:
        continue
      try:
        rec = json.loads(line)
      except ValueError:
        continue
      if kind is not None and not (isinstance(rec, dict) and
                                   rec.get('kind') == kind):
        continue
      out.append(rec)
  return out


_appender = JsonlAppender(ENV_VAR)


def run_log_path() -> Optional[str]:
  """The active flight-record path, or None (recording disabled)."""
  return os.environ.get(ENV_VAR) or None


def _jsonable(obj):
  """Best-effort JSON coercion: tuple/EdgeType dict keys become
  strings, arrays/odd leaves fall back to str — a flight record must
  never crash an epoch over an exotic config value."""
  if isinstance(obj, dict):
    return {str(k): _jsonable(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_jsonable(v) for v in obj]
  if isinstance(obj, (str, int, float, bool)) or obj is None:
    return obj
  return str(obj)


def config_fingerprint(config: dict) -> str:
  """Stable 16-hex digest of an emitter's static configuration —
  records from the same run share it, so a postmortem diff can group
  epochs by configuration across restarts."""
  blob = json.dumps(_jsonable(config or {}), sort_keys=True)
  return hashlib.sha1(blob.encode()).hexdigest()[:16]


def epoch_begin() -> Optional[dict]:
  """Snapshot the counter/dispatch baselines at epoch start. Returns
  an opaque token for :func:`epoch_end`, or None when recording is
  off (the fast path: one env read)."""
  path = run_log_path()
  if not path:
    return None
  from ..utils import trace
  from . import programs
  from .registry import default_registry
  return {'path': path,
          't0': time.perf_counter(),
          'counters': default_registry().counters(),
          'dispatch': trace.dispatch_snapshot(),
          'programs': programs.flight_snapshot()}


def _delta(now: dict, base: dict) -> dict:
  return {k: v - base.get(k, 0) for k, v in now.items()
          if v != base.get(k, 0)}


def epoch_end(token: Optional[dict], emitter: str, epoch: int,
              steps: int, config: Optional[dict] = None,
              completed: bool = True,
              extra: Optional[dict] = None) -> Optional[dict]:
  """Write this epoch's record (no-op when ``token`` is None). Returns
  the record dict that was appended.

  ``dispatch`` is the per-site delta of the ACTIVE ``count_dispatches``
  region (None when no region is active — the recorder never creates
  one); ``feature``/``resilience``/``fault`` split the metric-counter
  deltas by subsystem prefix so the acceptance check — record fields
  bit-match the live counters — is a plain dict compare.
  """
  if token is None:
    return None
  from ..utils import trace
  from . import programs, spans
  from .registry import default_registry
  wall = time.perf_counter() - token['t0']
  cdelta = _delta(default_registry().counters(), token['counters'])
  d_now = trace.dispatch_snapshot()
  if d_now is None or token['dispatch'] is None:
    dispatch = None
  else:
    dispatch = _delta(d_now, token['dispatch'])
  # program-observatory delta: which sites compiled/dispatched THIS
  # epoch (host bookkeeping only — epoch 1 shows the compiles, a
  # steady-state epoch shows pure dispatch counts, and a retrace
  # mid-run shows up as a compiles delta on an old site)
  prog_base = token.get('programs') or {}
  prog = {}
  for site, now in programs.flight_snapshot().items():
    base = prog_base.get(site, {})
    d = {k: round(v - base.get(k, 0), 6) for k, v in now.items()
         if v != base.get(k, 0)}
    if d:
      prog[site] = d

  def split(*prefixes):
    return {k: v for k, v in cdelta.items()
            if any(k.startswith(p + '.') for p in prefixes)}

  feature = split('dist_feature', 'dist_label')
  resilience = split('resilience')
  fault = split('fault')
  # per-epoch staging deltas (the out-of-core tiers, storage/): rows
  # and bytes the chunk-boundary pipeline staged this epoch, plus the
  # synchronous fallback reads (prefetch_miss) — a degrading prefetch
  # hit rate is visible epoch by epoch
  storage = split('storage')
  # multi-tenant backpressure deltas (distributed/tenancy.py): the
  # throttle/starve counters and backpressure_ms a contended epoch
  # accumulated — visible per epoch, next to the resilience story
  tenant = split('tenant')
  known = (set(feature) | set(resilience) | set(fault) | set(storage)
           | set(tenant))
  record = {
      'schema': SCHEMA,
      'kind': 'epoch',
      # run_id joins this record to metric scrapes and span trees from
      # the same run (spans.run_id — GLT_RUN_ID or minted per process)
      'run_id': spans.run_id(),
      'emitter': emitter,
      'epoch': int(epoch),
      'steps': int(steps),
      'completed': bool(completed),
      'wall_s': round(wall, 6),
      'dispatch': dispatch,
      'dispatch_total': (sum(dispatch.values())
                         if dispatch is not None else None),
      'feature': feature,
      'resilience': resilience,
      'fault': fault,
      'storage': storage,
      'tenant': tenant,
      'programs': prog,
      'counters': {k: v for k, v in cdelta.items() if k not in known},
      'config': _jsonable(config or {}),
      'config_fingerprint': config_fingerprint(config or {}),
      'trace': {'profile_dir': os.environ.get('GLT_PROFILE_DIR')},
      'time_unix': round(time.time(), 3),
  }
  if extra:
    record.update(_jsonable(extra))
  _appender.append(token['path'], record)
  return record


def end_for(obj, token: Optional[dict], *, steps: int,
            completed: bool = True, config: Optional[dict] = None,
            extra: Optional[dict] = None, emitter: Optional[str] = None,
            epoch: Optional[int] = None) -> Optional[dict]:
  """:func:`epoch_end` plus the per-emitter epoch counter: reads and
  advances ``obj._flight_epochs`` (lazily initialized) so every
  per-step emitter shares one bookkeeping implementation instead of
  re-rolling the getattr dance. ``epoch`` overrides the recorded
  number (emitters with their own counter, e.g. the remote loaders'
  ``_epoch``) — the instance counter still advances."""
  n = getattr(obj, '_flight_epochs', 0)
  rec = epoch_end(token, emitter=emitter or type(obj).__name__,
                  epoch=n if epoch is None else epoch, steps=steps,
                  completed=completed, config=config, extra=extra)
  obj._flight_epochs = n + 1
  return rec


def read_records(path: Optional[str] = None) -> list:
  """Parse a flight log back into record dicts (postmortem tooling /
  tests). Unparseable lines are skipped — a run killed mid-write must
  not take the rest of the log with it."""
  return read_jsonl(path or run_log_path())
