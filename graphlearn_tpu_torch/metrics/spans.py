"""Correlated spans: host-clock begin/end records joinable across the
cluster by one id.

The metrics layer answers "how many / how fast"; spans answer "WHICH
request / WHICH epoch, across WHICH processes". A span is a tiny
host-side record — name, span id, parent id, trace id, begin time,
duration, attrs — kept in a bounded in-process ring and (opt-in,
``GLT_SPAN_LOG``) appended as JSONL next to the flight recorder. No
device clocks, no fetches, no dispatches: one perf_counter read at each
end and a dict append. A span on the card's path reads no CUDA event and
makes no ``synchronize``: an ``epoch.chunk`` span times the host's
enqueue of one chunk (its graph replay), not the card's work.

The port's copy of ``graphlearn_tpu/metrics/spans.py``: the same record
schema, field for field, and the same environment variables
(``GLT_SPAN_LOG``, ``GLT_SPAN_BUFFER``, ``GLT_RUN_ID``), so span logs of
the two packages read alike and a trace crosses between them.

Correlation model:

* every process owns a ``run_id`` (``GLT_RUN_ID`` or minted once);
* a span's ``trace`` id defaults to the current thread's propagated
  trace, falling back to the process run_id — so an epoch's spans all
  carry the driving process's run_id, and a request's spans carry the
  request id minted at its edge;
* the context crosses processes explicitly: the RPC client puts
  :func:`wire_context` in request metadata and the server adopts it for
  the handler (``rpc.py``); the mp sampling producer ships it with each
  epoch command and workers adopt it (``dist_sampling_producer.py``);
  ``ServingEngine.submit`` captures it into the request so dispatcher-
  thread spans still join the submitting caller's trace.

Recovery: the local ring exports through ``spans.export()``;
``DistServer.get_metrics`` attaches the server's ring (and the
producers' worker rings) to its snapshot, so ``metrics.scrape_all()``
carries every role's spans — :func:`from_scrape` + :func:`build_tree`
reassemble one request's tree from the scrape plus the local ring, by
id alone. Span NAMES are a closed namespace
(``registry_names.REGISTERED_SPANS``) exactly like metric names.

Zero-dependency (pure stdlib), thread-safe, process-local.
"""
import collections
import contextlib
import logging
import os
import sys
import threading
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

ENV_LOG = 'GLT_SPAN_LOG'
ENV_RUN = 'GLT_RUN_ID'
ENV_BUFFER = 'GLT_SPAN_BUFFER'
SCHEMA = 1

#: newest spans a scrape leg ships (get_metrics, scrape_all's local
#: snapshot, worker epoch-end publishes): a busy ring re-serialized on
#: every monitoring poll must stay bounded; full-fidelity recovery is
#: the GLT_SPAN_LOG JSONL's job, the scrape carries the recent window
SCRAPE_EXPORT_LIMIT = 1024

logger = logging.getLogger('graphlearn_tpu_torch.spans')

_lock = threading.Lock()
_run_id: Optional[str] = None
_proc_tag = uuid.uuid4().hex[:8]
_counter = 0
_tls = threading.local()


def run_id() -> str:
  """This process's run identity: ``GLT_RUN_ID`` when set (one value
  across a whole launch joins every process's records), else minted
  once per process. Stamped into flight records and scrape snapshots so
  a flight line and a scrape from the same run join on it."""
  global _run_id
  if _run_id is None:
    with _lock:
      if _run_id is None:
        _run_id = os.environ.get(ENV_RUN) or uuid.uuid4().hex[:16]
  return _run_id


def span_log_path() -> Optional[str]:
  return os.environ.get(ENV_LOG) or None


def _next_span_id() -> str:
  global _counter
  with _lock:
    _counter += 1
    return f'{_proc_tag}-{_counter:x}'


def _stack() -> list:
  st = getattr(_tls, 'stack', None)
  if st is None:
    st = _tls.stack = []
  return st


def current() -> Tuple[Optional[str], Optional[str]]:
  """(trace_id, span_id) of the innermost attached span on this thread,
  or the adopted remote context, or (None, None)."""
  st = _stack()
  return st[-1] if st else (None, None)


def current_trace() -> str:
  """The trace id new spans on this thread will join: the propagated
  context when one is attached, else the process run_id."""
  trace, _ = current()
  return trace or run_id()


def wire_context() -> Dict[str, Optional[str]]:
  """The propagation payload for RPC metadata / mp command payloads:
  ``{'trace': ..., 'span': ...}`` (span may be None at a trace root)."""
  trace, span_id = current()
  return {'trace': trace or run_id(), 'span': span_id}


@contextlib.contextmanager
def adopt(ctx: Optional[dict]):
  """Adopt a remote :func:`wire_context` for this thread (RPC handler,
  mp worker epoch): spans opened inside join the remote trace and
  parent under the remote span. A None/empty ctx is a no-op."""
  if not ctx or not ctx.get('trace'):
    yield
    return
  st = _stack()
  st.append((ctx['trace'], ctx.get('span')))
  try:
    yield
  finally:
    if st and st[-1] == (ctx['trace'], ctx.get('span')):
      st.pop()


@contextlib.contextmanager
def new_trace(trace_id: Optional[str] = None):
  """Mint (or adopt) a fresh trace id — the REQUEST id pattern: open
  one around a client call and every span it causes, across every
  process it touches, joins that id. Yields the id."""
  trace_id = trace_id or uuid.uuid4().hex[:16]
  st = _stack()
  st.append((trace_id, None))
  try:
    yield trace_id
  finally:
    if st and st[-1] == (trace_id, None):
      st.pop()


# ----------------------------------------------------------------- recorder


class SpanRecorder:
  """Bounded ring of finished span records (plain dicts)."""

  def __init__(self, maxlen: int = 4096):
    self._lock = threading.Lock()
    self._ring = collections.deque(maxlen=maxlen)

  def record(self, rec: dict):
    with self._lock:
      self._ring.append(rec)

  def export(self, trace: Optional[str] = None,
             limit: Optional[int] = None) -> List[dict]:
    with self._lock:
      out = [r for r in self._ring
             if trace is None or r.get('trace') == trace]
    return out[-limit:] if limit else out

  def reset(self):
    with self._lock:
      self._ring.clear()


def _ring_maxlen() -> int:
  # a malformed tuning knob must not make the package unimportable
  # (observability never kills work): unparseable values fall back
  try:
    return max(64, int(os.environ.get(ENV_BUFFER, '') or 4096))
  except ValueError:
    logger.warning('%s=%r is not an integer — using the default 4096',
                   ENV_BUFFER, os.environ.get(ENV_BUFFER))
    return 4096


_recorder = SpanRecorder(maxlen=_ring_maxlen())


def recorder() -> SpanRecorder:
  return _recorder


def export(trace: Optional[str] = None,
           limit: Optional[int] = None) -> List[dict]:
  """Finished spans from this process's ring (newest last)."""
  return _recorder.export(trace, limit)


def reset():
  _recorder.reset()


def _profile_key() -> Optional[str]:
  """The active profiler trace key, when a maybe_start_trace session
  is live — stamps device traces onto host spans so a Chrome trace and
  a span tree correlate (sys.modules probe keeps this module
  zero-dependency and cycle-free)."""
  tr = sys.modules.get('graphlearn_tpu_torch.utils.trace')
  if tr is not None and getattr(tr, '_active', False):
    return (getattr(tr, '_active_dir', None)
            or os.environ.get('GLT_PROFILE_DIR'))
  return None


# spans emit per-RPC / per-request: the shared appender keeps a
# flushed handle open between records instead of paying an open/close
# per span on the very hot paths the spans are timing (flight.py owns
# the implementation; flight itself writes once per epoch, unbuffered)
from .flight import JsonlAppender, read_jsonl as _read_jsonl  # noqa: E402

_writer = JsonlAppender(ENV_LOG, keep_open=True)


def _write(rec: dict):
  path = span_log_path()
  if path:
    _writer.append(path, rec)


def _jsonable_attrs(attrs: dict) -> dict:
  from .flight import _jsonable
  return {str(k): _jsonable(v) for k, v in attrs.items()}


# ------------------------------------------------------------ span lifecycle


class _SpanToken:
  __slots__ = ('name', 'span_id', 'parent', 'trace', 't0', 't0_unix',
               'attrs', 'attached', 'done')

  def __init__(self, name, span_id, parent, trace, attrs, attached):
    self.name = name
    self.span_id = span_id
    self.parent = parent
    self.trace = trace
    self.t0 = time.perf_counter()
    self.t0_unix = time.time()
    self.attrs = attrs
    self.attached = attached
    self.done = False


def begin(name: str, parent: Optional[str] = None,
          trace: Optional[str] = None, attach: bool = True,
          **attrs) -> _SpanToken:
  """Open a span. With ``attach=True`` (default) it becomes this
  thread's current span until :func:`end` — children opened on the
  thread parent under it. ``attach=False`` is for spans that live
  across threads (a serving request handed to the dispatcher): pass
  ``parent``/``trace`` explicitly or let them default to the caller's
  current context."""
  cur_trace, cur_span = current()
  tok = _SpanToken(name, _next_span_id(),
                   parent if parent is not None else cur_span,
                   trace or cur_trace or run_id(), dict(attrs), attach)
  if attach:
    _stack().append((tok.trace, tok.span_id))
  return tok


def end(tok: Optional[_SpanToken], **attrs) -> Optional[dict]:
  """Close a span and record it (idempotent; None token is a no-op —
  the epoch_begin/epoch_end falsy-token convention)."""
  if tok is None or tok.done:
    return None
  tok.done = True
  if tok.attached:
    st = _stack()
    if (tok.trace, tok.span_id) in st:
      st.remove((tok.trace, tok.span_id))
  if attrs:
    tok.attrs.update(attrs)
  rec = {
      'schema': SCHEMA, 'kind': 'span', 'name': tok.name,
      'span': tok.span_id, 'parent': tok.parent, 'trace': tok.trace,
      'run': run_id(), 'pid': os.getpid(),
      't0_unix': round(tok.t0_unix, 6),
      'dur_ms': round((time.perf_counter() - tok.t0) * 1e3, 6),
  }
  if tok.attrs:
    rec['attrs'] = _jsonable_attrs(tok.attrs)
  key = _profile_key()
  if key:
    rec['profile_key'] = key
  _recorder.record(rec)
  _write(rec)
  return rec


@contextlib.contextmanager
def span(name: str, **attrs):
  """``with spans.span('epoch.chunk', k=4):`` — begin/end with error
  annotation on an exception escaping the block."""
  tok = begin(name, **attrs)
  try:
    yield tok
  except BaseException as e:
    end(tok, error=f'{type(e).__name__}: {e}')
    raise
  finally:
    end(tok)


def emit(name: str, *, trace: Optional[str] = None,
         parent: Optional[str] = None, t0_unix: Optional[float] = None,
         dur_ms: float = 0.0, **attrs) -> dict:
  """Record a RETROACTIVE span — a phase whose bounds were measured as
  plain timestamps (queue wait measured at batch pickup). Same record
  shape as begin/end."""
  rec = {
      'schema': SCHEMA, 'kind': 'span', 'name': name,
      'span': _next_span_id(), 'parent': parent,
      'trace': trace or current_trace(), 'run': run_id(),
      'pid': os.getpid(),
      't0_unix': round(t0_unix if t0_unix is not None else time.time(),
                       6),
      'dur_ms': round(dur_ms, 6),
  }
  if attrs:
    rec['attrs'] = _jsonable_attrs(attrs)
  key = _profile_key()
  if key:
    rec['profile_key'] = key
  _recorder.record(rec)
  _write(rec)
  return rec


# ------------------------------------------------------------ tree assembly


def read_log(path: Optional[str] = None) -> List[dict]:
  """Parse a GLT_SPAN_LOG back into span records (garbage lines
  skipped — the shared flight.read_jsonl tolerance)."""
  return _read_jsonl(path or span_log_path(), kind='span')


def from_scrape(scrapes: Dict[str, dict],
                trace: Optional[str] = None) -> List[dict]:
  """Every span a ``metrics.scrape_all()`` result carries (each role
  snapshot's ``spans`` list), optionally filtered by trace id."""
  out: List[dict] = []
  for snap in scrapes.values():
    if not isinstance(snap, dict) or 'error' in snap:
      continue
    for rec in snap.get('spans', ()) or ():
      if trace is None or rec.get('trace') == trace:
        out.append(rec)
  return out


def dedupe(spans_: Iterable[dict]) -> List[dict]:
  """One record per span id (a span can arrive via both the local ring
  and a scrape leg, or the ring and the JSONL)."""
  seen, out = set(), []
  for rec in spans_:
    sid = rec.get('span')
    if sid in seen:
      continue
    seen.add(sid)
    out.append(rec)
  return out


def build_tree(spans_: Iterable[dict]) -> dict:
  """{'roots': [span_id...], 'children': {span_id: [span_id...]},
  'spans': {span_id: record}, 'orphans': [span_id...]} — orphans are
  spans whose parent id is set but absent from the collection (the
  chaos suite asserts there are none after a failover/respawn)."""
  spans_ = dedupe(spans_)
  index = {rec['span']: rec for rec in spans_}
  children: Dict[str, list] = {}
  roots, orphans = [], []
  for rec in sorted(spans_, key=lambda r: r.get('t0_unix', 0.0)):
    parent = rec.get('parent')
    if parent is None:
      roots.append(rec['span'])
    elif parent in index:
      children.setdefault(parent, []).append(rec['span'])
    else:
      orphans.append(rec['span'])
  return dict(roots=roots, children=children, spans=index,
              orphans=orphans)
