"""Profiling hooks, dispatch counting and event counters.

The port's counterpart of ``graphlearn_tpu/utils/trace.py``, in three
parts:

* the profiler, over ``torch.profiler`` (CPU ops, and on a card the
  CUDA kernels and copies): :func:`profile_trace` captures a region and
  exports it as a Chrome trace under ``logdir``; :func:`annotate` /
  :func:`step_annotation` name a range (``record_function``, plus an
  NVTX range on a card); :func:`maybe_start_trace` / :func:`stop_trace`
  capture between two calls when ``GLT_PROFILE_DIR`` names a directory;
  :func:`device_program_ms` / :func:`device_op_ms` read the newest
  exported trace back. These are no-ops when no trace is active, so
  loaders annotate unconditionally.
* dispatch counting (:func:`count_dispatches`, :func:`record_dispatch`,
  :func:`dispatch_snapshot`, :func:`wrap_dispatch`). In the port ONE
  DISPATCH IS ONE GRAPH REPLAY OR ONE EAGER CALL at a named site — a
  chunk (``scan_chunk``: a captured chunk's replay, or the warm-up or
  ``capture=False`` chunk run eagerly), an epoch's seed prologue, a
  store lookup — never one kernel launch. The kernels keep their own
  launch counters (``ops.launch_counts()``, ``ops/kernels.py``); a
  replay adds the launches its graph recorded there.
* the event counters (``counter_inc``, ``counter_get``, ``counters``,
  ``reset_counters``) over the port's ``metrics`` registry, so they
  appear in ``metrics.snapshot()`` beside gauges and histograms.

Usage::

    with gtt.utils.profile_trace('/tmp/glt_trace'):
      state, losses, accs = trainer.run_epoch(state)
    gtt.utils.device_op_ms('/tmp/glt_trace', top=10)

or env-driven: set GLT_PROFILE_DIR and call maybe_start_trace() /
stop_trace() around the region of interest.
"""
import contextlib
import functools
import os
import socket
import time
from typing import Callable, Iterator, Optional

#: the trace-event categories of work on the card: kernels, copies and
#: fills (what ``device_op_ms`` sums); a trace with none of them is a
#: CPU run's, whose device is the CPU (its ``cpu_op`` events)
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _activities():
  import torch
  from torch.profiler import ProfilerActivity
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  return acts


def _export(prof, logdir: str) -> str:
  """Write ``prof``'s Chrome trace under ``logdir`` (one file per
  capture, named like torch's tensorboard handler's)."""
  os.makedirs(logdir, exist_ok=True)
  path = os.path.join(logdir, f'{socket.gethostname()}.{os.getpid()}.'
                      f'{time.time_ns()}.pt.trace.json')
  prof.export_chrome_trace(path)
  return path


def _sync():
  """Let the card's queued work reach the trace before it stops."""
  import torch
  if torch.cuda.is_available() and torch.cuda.is_initialized():
    torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[object]:
  """Capture a ``torch.profiler`` trace of the enclosed region (CPU ops,
  and on a card its kernels and copies), exported as a Chrome trace
  under ``logdir``. Yields the profiler."""
  from torch.profiler import profile
  with profile(activities=_activities()) as prof:
    try:
      yield prof
    finally:
      _sync()
  _export(prof, logdir)


def _label(name: str, kwargs: dict) -> str:
  """``name#k=v,...#``: JAX's TraceMe encoding of a range's metadata."""
  if not kwargs:
    return name
  return name + '#' + ','.join(f'{k}={v}' for k, v in kwargs.items()) + '#'


@contextlib.contextmanager
def annotate(name: str, **kwargs):
  """Named range: a ``record_function`` range (seen by an active
  profiler, free otherwise) and, on a card, an NVTX range."""
  import torch
  label = _label(name, kwargs)
  nvtx = torch.cuda.is_available()
  if nvtx:
    torch.cuda.nvtx.range_push(label)
  try:
    with torch.profiler.record_function(label):
      yield
  finally:
    if nvtx:
      torch.cuda.nvtx.range_pop()


def step_annotation(name: str, step: int):
  """Step-numbered range (loader batches, train steps)."""
  return annotate(name, step_num=step)


_trace_cache = {}   # (path, mtime) -> parsed events (newest entry only)


def _trace_events(trace_dir: str) -> list:
  """Duration ('X') events of the newest Chrome trace under
  ``trace_dir`` — the shared loader behind device_program_ms /
  device_op_ms, memoized on (path, mtime) so both views of one trace
  parse it once."""
  import glob
  import gzip
  import json
  paths = (glob.glob(trace_dir + '/**/*.pt.trace.json', recursive=True) +
           glob.glob(trace_dir + '/**/*.pt.trace.json.gz', recursive=True))
  if not paths:
    return []
  newest = max(paths, key=os.path.getmtime)
  key = (newest, os.path.getmtime(newest))
  if key in _trace_cache:
    return _trace_cache[key]
  opener = gzip.open if newest.endswith('.gz') else open
  with opener(newest, 'rt') as f:
    t = json.load(f)
  events = [e for e in t.get('traceEvents', [])
            if e.get('ph') == 'X' and 'dur' in e]
  _trace_cache.clear()            # keep only the newest trace in memory
  _trace_cache[key] = events
  return events


def _on_device(events: list, card_cats, cpu_cats) -> list:
  """The events of the trace's device: ``card_cats`` where the trace
  holds any card work, else ``cpu_cats`` (a CPU run's device)."""
  card = [e for e in events if e.get('cat') in _DEVICE_CATS]
  cats = card_cats if card else cpu_cats
  return [e for e in events if e.get('cat') in cats]


def device_program_ms(trace_dir: str):
  """Per-program average device ms from the newest trace under
  ``trace_dir``. A program is a named range (:func:`annotate`,
  :func:`step_annotation`, a ``record_function``) as the card's
  timeline shows it (``gpu_user_annotation``), or on a CPU run the
  range itself.

  Returns {name: (avg_ms, call_count)}.
  """
  import collections
  durs = collections.defaultdict(lambda: [0.0, 0])
  for e in _on_device(_trace_events(trace_dir), ('gpu_user_annotation',),
                      ('user_annotation',)):
    d = durs[e.get('name', '')]
    d[0] += e['dur']
    d[1] += 1
  return {n: (tot / cnt / 1000.0, cnt) for n, (tot, cnt) in durs.items()}


def device_op_ms(trace_dir: str, top: int = 0, steps: int = 1,
                 strip_ids: bool = True):
  """Per-OP device ms from the newest trace under ``trace_dir``: each
  kernel, copy and fill on a card (one event per launch), or each CPU
  op of a CPU run — the op-level companion of device_program_ms.

  ``steps`` divides the ms totals (pass the traced step count).
  ``strip_ids`` groups instances by name with a trailing ``.NNN``
  suffix removed (``fusion.123`` -> ``fusion``; bare-digit names like
  ``layer1`` are left intact). Returns {name: (ms, count)}, sorted desc
  and truncated when ``top`` > 0.
  """
  import collections
  import re
  durs = collections.defaultdict(lambda: [0.0, 0])
  suffix = re.compile(r'\.\d+$')
  for e in _on_device(_trace_events(trace_dir), _DEVICE_CATS, ('cpu_op',)):
    n = e.get('name', '')
    if strip_ids:
      n = suffix.sub('', n)
    d = durs[n]
    d[0] += e['dur']
    d[1] += 1
  out = {n: (tot / 1000.0 / steps, cnt)
         for n, (tot, cnt) in durs.items()}
  if top:
    out = dict(sorted(out.items(), key=lambda kv: -kv[1][0])[:top])
  return out


# ---------------------------------------------------------------- dispatch
# Dispatch counting: the loaders and trainers name their dispatch sites
# (record_dispatch right before a graph replay or an eager call at the
# site), and tests assert dispatches per epoch. The counter is a
# host-side convention, exact for the instrumented paths and free (one
# None check) otherwise.


class DispatchCounter:
  """Per-site dispatch counts (see count_dispatches)."""

  def __init__(self):
    self.counts = {}

  @property
  def total(self) -> int:
    return sum(self.counts.values())

  def record(self, name: str = 'program'):
    self.counts[name] = self.counts.get(name, 0) + 1

  def subtotal(self, prefix: str) -> int:
    """Dispatches whose site name starts with ``prefix`` ('dist_' for
    the distributed hot path)."""
    return sum(v for k, v in self.counts.items() if k.startswith(prefix))

  def __repr__(self):
    return f'DispatchCounter(total={self.total}, counts={self.counts})'


_dispatch_counter: Optional[DispatchCounter] = None


@contextlib.contextmanager
def count_dispatches(propagate: bool = False) -> Iterator[DispatchCounter]:
  """Count instrumented dispatches in the enclosed region.

  Yields the active DispatchCounter; read ``.total`` / ``.counts`` after
  the block. Nesting restores the outer counter on exit; by default the
  inner region's dispatches are NOT added to the outer count — pass
  ``propagate=True`` to fold the inner region's per-site counts into
  the enclosing counter on exit (a no-op at top level)."""
  global _dispatch_counter
  prev, _dispatch_counter = _dispatch_counter, DispatchCounter()
  try:
    yield _dispatch_counter
  finally:
    inner, _dispatch_counter = _dispatch_counter, prev
    if propagate and prev is not None:
      for name, n in inner.counts.items():
        prev.counts[name] = prev.counts.get(name, 0) + n


def dispatch_snapshot() -> Optional[dict]:
  """Copy of the active count_dispatches region's per-site counts, or
  None when no region is active — the flight recorder's read hook."""
  return dict(_dispatch_counter.counts) \
      if _dispatch_counter is not None else None


def _capturing() -> bool:
  import torch
  return torch.cuda.is_available() and \
      torch.cuda.is_current_stream_capturing()


def record_dispatch(name: str = 'program'):
  """Count one dispatch under ``name`` (no-op when no count_dispatches()
  region is active). Call at the dispatch SITE, on the host. A call made
  while the current stream captures a CUDA graph is no dispatch (the
  graph's replays are), so a site inside a captured chunk counts
  nothing."""
  if _dispatch_counter is not None and not _capturing():
    _dispatch_counter.record(name)


def wrap_dispatch(fn: Callable, name: Optional[str] = None) -> Callable:
  """Counting wrapper: each call records one dispatch under ``name``
  (default: the function's name). For code outside this package
  (bench loops, tests) whose sites the built-in instrumentation doesn't
  cover."""
  label = name or getattr(fn, '__name__', 'program')

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    record_dispatch(label)
    return fn(*args, **kwargs)

  return wrapper


# ---------------------------------------------------------------- counters

_metric_registry = None


def _registry():
  global _metric_registry
  if _metric_registry is None:
    from ..metrics.registry import default_registry
    _metric_registry = default_registry()
  return _metric_registry


def counter_inc(name: str, n: int = 1):
  """Add ``n`` to the named event counter (creating it at 0)."""
  _registry().inc(name, n)


def counter_get(name: str) -> int:
  return _registry().counter_value(name)


def counters(prefix: str = '') -> dict:
  """Snapshot of counters, optionally filtered by name prefix."""
  return _registry().counters(prefix)


def reset_counters(prefix: str = ''):
  """Drop counters matching ``prefix`` (all by default): counters only;
  gauges and histograms are reset through ``metrics.reset()``."""
  _registry().reset_counters(prefix)


# ------------------------------------------------------ env-driven capture

_active = False
_active_dir: Optional[str] = None
_active_prof = None


def active_profile_dir() -> Optional[str]:
  """The live maybe_start_trace() session's log dir, or None. Spans
  opened while a session is live stamp this key (metrics/spans.py
  ``profile_key``), so device traces and host span trees correlate."""
  return _active_dir if _active else None


def maybe_start_trace(env_var: str = 'GLT_PROFILE_DIR') -> Optional[str]:
  """Start a trace if ``env_var`` names a directory; returns the dir.

  Exception-safe: a start that raises leaves ``_active`` False and
  best-effort-closes the half-opened profiler, so a later call is not
  wedged by it."""
  global _active, _active_dir, _active_prof
  logdir = os.environ.get(env_var)
  if logdir and not _active:
    from torch.profiler import profile
    prof = profile(activities=_activities())
    try:
      prof.start()
    except BaseException:
      _active, _active_dir, _active_prof = False, None, None
      try:       # close a partially-started session
        prof.stop()
      except Exception:  # noqa: BLE001 - cleanup of a failed start
        pass
      raise
    _active, _active_dir, _active_prof = True, logdir, prof
    return logdir
  return None


def stop_trace():
  """Stop the maybe_start_trace() session and export its trace under
  the session's directory. Exception-safe: ``_active`` is cleared
  FIRST, so a stop or export that raises cannot leave every later
  maybe_start_trace a silent no-op."""
  global _active, _active_dir, _active_prof
  if _active:
    prof, logdir = _active_prof, _active_dir
    _active, _active_dir, _active_prof = False, None, None
    _sync()
    prof.stop()
    _export(prof, logdir)
