"""Program observatory: capture / recapture counts per dispatch site.

The port's counterpart of ``graphlearn_tpu/metrics/programs.py``. JAX
counts the programs XLA compiles; the port's counterpart of a compile is
a CUDA graph capture. A chunked trainer (``ScanTrainer`` and the others
built on its frame) captures one graph per chunk length and replays it
for every chunk of that length, so its program population is the set of
captured graphs:

* the site names are the ``record_dispatch`` names (``scan_chunk``,
  ``dist_scan_chunk``, ...): one vocabulary for dispatch budgets, flight
  records and the observatory;
* each capture is one :meth:`ProgramRegistry.on_compile` with its
  signature — the chunk length, the static buffers' shapes and dtypes,
  and what the graph freezes of the train state (the optimizer, the
  parameters' and its state's storage, each group's hyperparameters);
* a recapture — the trainer dropped its graphs because the train state
  it is handed is not the one they froze — is a retrace, and
  :func:`diff_signatures` names what changed ("arg 6: static:'lr=0.01'
  -> static:'lr=0.001'");
* each graph replay (and each eager chunk: the warm-up, or
  ``capture=False``) is one dispatch.

:func:`instrument` wraps any callable the JAX way: it counts a compile
when the callable's ``_cache_size()`` grows across a call, and only
dispatches when it has none. :func:`retrace_budget` raises under
``GLT_STRICT`` and warns otherwise. ``program.compiles`` /
``program.retraces`` / ``program.compile_ms`` land in the metric
registry and the flight recorder embeds the per-site delta of
:func:`flight_snapshot` as each epoch record's ``programs`` field.

JAX-only: ``capture_cost`` and ``cost_enabled`` (``GLT_PROGRAM_COST``)
read XLA's cost and memory analysis of a compiled program, which a CUDA
graph does not carry; ``aggregate()`` keeps their keys at None. Pure
stdlib at import.
"""
import collections
import contextlib
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

#: signatures longer than this keep only a prefix in the stored event
#: (the diff walks the FULL tuples — via each site's last_signature —
#: before the event stores its truncated copy)
_SIG_STORE_LIMIT = 64

#: compile-event ring bound: a pathological retrace storm — the exact
#: failure the observatory exists to surface — must not leak host
#: memory linearly in a long-lived server (cost totals accumulate in
#: running scalars, so eviction never under-reports the aggregate)
_EVENT_RING = 1024


class RetraceBudgetExceeded(RuntimeError):
  """A retrace_budget() region compiled more programs than allowed."""


# ---------------------------------------------------------------- signature


def _leaf_desc(leaf) -> str:
  """One leaf's abstract signature: ``dtype[shape]`` for array-likes (a
  torch dtype without its ``torch.`` prefix, so a tensor reads as the
  JAX array of its shape and dtype does), ``static:<repr>`` for
  everything else (chunk lengths, config scalars). Host-only attribute
  reads — never forces a value."""
  shape = getattr(leaf, 'shape', None)
  dtype = getattr(leaf, 'dtype', None)
  if shape is not None and dtype is not None:
    name = str(dtype)
    if name.startswith('torch.'):
      name = name[len('torch.'):]
    return f'{name}[{",".join(str(s) for s in shape)}]'
  if isinstance(leaf, (int, float, bool, str, bytes, type(None))):
    return f'static:{leaf!r}'
  return f'static:<{type(leaf).__name__}>'


def _leaves(tree) -> list:
  """Leaves of nested tuples, lists and dicts (dicts in sorted key
  order, as ``jax.tree_util`` flattens them); None is no leaf."""
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k])]
  if isinstance(tree, (tuple, list)):
    return [x for v in tree for x in _leaves(v)]
  return [] if tree is None else [tree]


def signature_of(args: tuple, kwargs: dict) -> Tuple[str, ...]:
  """Flat abstract signature of a call's arguments (shapes, dtypes,
  static values) — what a captured graph is specialised to. Computed
  only when a capture is detected, so the per-dispatch cost stays one
  cache-size read."""
  return tuple(_leaf_desc(leaf)
               for leaf in _leaves((args, dict(kwargs or {}))))


def diff_signatures(prev: Optional[Tuple[str, ...]],
                    new: Tuple[str, ...], limit: int = 4) -> str:
  """Human-readable "why did this retrace": the per-argument changes
  between the previous compile's signature and this one's."""
  if prev is None:
    return 'first compile'
  msgs = []
  if len(prev) != len(new):
    msgs.append(f'arg count {len(prev)} -> {len(new)}')
  for i, (a, b) in enumerate(zip(prev, new)):
    if a != b:
      msgs.append(f'arg {i}: {a} -> {b}')
  if not msgs:
    return ('signature unchanged — retrace from non-argument state '
            '(dropped graphs, or a cleared cache)')
  shown = msgs[:limit]
  if len(msgs) > limit:
    shown.append(f'(+{len(msgs) - limit} more)')
  return '; '.join(shown)


# ----------------------------------------------------------------- registry


class CompileEvent:
  """One compile at one site: when, how long the triggering call took,
  what signature triggered it, and why it differed from the last one."""

  __slots__ = ('site', 'index', 'wall_s', 'time_unix', 'signature',
               'diff', 'cost')

  def __init__(self, site: str, index: int, wall_s: float,
               signature: Tuple[str, ...], diff: str,
               cost: Optional[dict] = None):
    self.site = site
    self.index = index          # 0 = first compile; >= 1 = retrace
    self.wall_s = wall_s        # wall of the triggering call (trace +
    self.time_unix = time.time()  # compile + first execute)
    self.signature = signature
    self.diff = diff
    self.cost = cost

  def as_dict(self) -> dict:
    return dict(site=self.site, index=self.index,
                wall_s=round(self.wall_s, 6),
                time_unix=round(self.time_unix, 3),
                signature=list(self.signature[:_SIG_STORE_LIMIT]),
                diff=self.diff, cost=self.cost)


class _Site:
  __slots__ = ('compiles', 'dispatches', 'compile_s', 'last_signature',
               'last_event')

  def __init__(self):
    self.compiles: int = 0
    self.dispatches: int = 0
    self.compile_s: float = 0.0
    self.last_signature: Optional[Tuple[str, ...]] = None
    self.last_event: Optional[CompileEvent] = None


class ProgramRegistry:
  """Process-local, thread-safe site -> compile/dispatch/cost store.

  Fed by :func:`instrument` wrappers at the package's dispatch sites;
  read by ``retrace_budget``, the flight recorder (per-epoch deltas of
  :meth:`flight_snapshot`) and bench.py (:meth:`aggregate`)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._sites: Dict[str, _Site] = {}
    self._events = collections.deque(maxlen=_EVENT_RING)
    self._flops_total: Optional[float] = None
    self._peak_hbm: Optional[float] = None

  def _site(self, name: str) -> _Site:
    s = self._sites.get(name)
    if s is None:
      s = self._sites[name] = _Site()
    return s

  def on_dispatch(self, site: str):
    with self._lock:
      self._site(site).dispatches += 1

  def on_compile(self, site: str, signature: Tuple[str, ...],
                 wall_s: float, cost: Optional[dict] = None
                 ) -> CompileEvent:
    with self._lock:
      s = self._site(site)
      diff = diff_signatures(s.last_signature, signature)
      # the event keeps a TRUNCATED signature copy (the full tuple
      # lives once per site in last_signature, for the next diff) so a
      # retrace storm's event ring holds bounded strings, not hundreds
      # of leaf descriptors per event
      ev = CompileEvent(site, s.compiles, wall_s,
                        signature[:_SIG_STORE_LIMIT], diff, cost)
      s.compiles += 1
      s.dispatches += 1
      s.compile_s += wall_s
      s.last_signature = signature
      s.last_event = ev
      self._events.append(ev)
      if cost and 'error' not in cost:
        if cost.get('flops') is not None:
          self._flops_total = (self._flops_total or 0.0) + \
              float(cost['flops'])
        if cost.get('peak_hbm_bytes') is not None:
          self._peak_hbm = max(self._peak_hbm or 0.0,
                               float(cost['peak_hbm_bytes']))
    # registry metrics AFTER the lock: the metric registry has its own
    from . import registry as _reg
    r = _reg.default_registry()
    r.inc('program.compiles')
    if ev.index > 0:
      r.inc('program.retraces')
    r.observe('program.compile_ms', wall_s * 1e3)
    return ev

  # -- reads -----------------------------------------------------------

  def compile_count(self, site: Optional[str] = None) -> int:
    with self._lock:
      if site is not None:
        s = self._sites.get(site)
        return s.compiles if s else 0
      return sum(s.compiles for s in self._sites.values())

  def retrace_count(self, site: Optional[str] = None) -> int:
    c = self.compile_count(site)
    if site is not None:
      return max(0, c - 1) if c else 0
    with self._lock:
      return sum(max(0, s.compiles - 1) for s in self._sites.values())

  def dispatch_count(self, site: str) -> int:
    with self._lock:
      s = self._sites.get(site)
      return s.dispatches if s else 0

  def last_compile(self, site: str) -> Optional[CompileEvent]:
    with self._lock:
      s = self._sites.get(site)
      return s.last_event if s else None

  def events(self, site: Optional[str] = None) -> List[CompileEvent]:
    with self._lock:
      return [e for e in self._events
              if site is None or e.site == site]

  def sites(self) -> List[str]:
    with self._lock:
      return sorted(self._sites)

  def flight_snapshot(self) -> Dict[str, dict]:
    """{site: {'compiles', 'dispatches', 'compile_s'}} — the flight
    recorder diffs two of these into an epoch's ``programs`` field."""
    with self._lock:
      return {n: dict(compiles=s.compiles, dispatches=s.dispatches,
                      compile_s=round(s.compile_s, 6))
              for n, s in self._sites.items()}

  def stats(self) -> Dict[str, dict]:
    """Per-site detail view (postmortem / bench tooling): counts plus
    the last compile's signature diff and captured cost."""
    with self._lock:
      out = {}
      for n, s in self._sites.items():
        out[n] = dict(
            compiles=s.compiles, retraces=max(0, s.compiles - 1),
            dispatches=s.dispatches, compile_s=round(s.compile_s, 6),
            last=(s.last_event.as_dict() if s.last_event else None))
      return out

  def aggregate(self) -> dict:
    """Whole-process totals — the bench keys (compile_count,
    compile_time_s_total, retrace_count, program_flops_total,
    program_peak_hbm_mb). The cost totals stay None unless a caller
    passes ``cost=`` to :meth:`on_compile` (the port captures none);
    they accumulate in running scalars, so event-ring eviction never
    under-reports them."""
    with self._lock:
      flops, peak = self._flops_total, self._peak_hbm
      return dict(
          compile_count=sum(s.compiles for s in self._sites.values()),
          retrace_count=sum(max(0, s.compiles - 1)
                            for s in self._sites.values()),
          compile_time_s_total=round(
              sum(s.compile_s for s in self._sites.values()), 6),
          program_flops_total=flops,
          program_peak_hbm_mb=(round(peak / 2**20, 3)
                               if peak is not None else None))

  def reset(self):
    with self._lock:
      self._sites.clear()
      self._events.clear()
      self._flops_total = None
      self._peak_hbm = None


_default = ProgramRegistry()


def default_program_registry() -> ProgramRegistry:
  return _default


def reset():
  _default.reset()


# -------------------------------------------------------------- instrument


def _cache_size_reader(fn) -> Optional[Callable[[], int]]:
  """The callable's program-cache-size hook, when it has one (an object
  that keeps one captured graph per signature exposes ``_cache_size``;
  a plain callable doesn't)."""
  reader = getattr(fn, '_cache_size', None)
  return reader if callable(reader) else None


def instrument(fn: Callable, site: str,
               registry: Optional[ProgramRegistry] = None) -> Callable:
  """Wrap a callable so every call feeds the program observatory under
  ``site`` (the site names are the record_dispatch names — one
  vocabulary for budgets, flight records and the observatory).

  Per call: one cache-size read after the dispatch. When the cache
  grew, the call captured (compiled): the signature is computed
  (host-only) and diffed against the site's previous capture.
  Callables without cache introspection (plain functions, eager
  fallbacks) degrade to dispatch-counting only. Idempotent:
  instrumenting an instrumented wrapper returns it unchanged (same
  site) or re-sites it."""
  import functools
  inner = getattr(fn, '_glt_instrumented', None)
  if inner is not None:
    fn = inner
  reg = registry or _default
  reader = _cache_size_reader(fn)
  # compile attribution is a WATERMARK on the cache size, advanced
  # under a wrapper-local lock (bookkeeping only — the dispatch itself
  # runs unlocked): two threads racing the same first call both see
  # the cache grow, but only the one that advances the watermark
  # records the compile — no spurious retraces, no double counts
  state = {'seen': reader() if reader is not None else 0}
  state_lock = threading.Lock()

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    if reader is None:
      reg.on_dispatch(site)
      return fn(*args, **kwargs)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    after = reader()
    compiled = False
    if after != state['seen']:
      with state_lock:
        if after > state['seen']:
          # N concurrent distinct-signature first calls may advance the
          # watermark in one jump; the winner records ONE compile (we
          # only hold one signature) — an under-count of N-1 in that
          # race, never a spurious retrace
          state['seen'] = after
          compiled = True
        elif after < state['seen']:
          # the cache SHRANK (dropped graphs / eviction): re-arm
          # the watermark at the new size and attribute this call as a
          # compile — after a cache clear the very next dispatch IS the
          # recompile, and a frozen high watermark would hide the whole
          # recompile storm from retrace_budget forever
          state['seen'] = after
          compiled = True
    if compiled:
      reg.on_compile(site, signature_of(args, kwargs),
                     time.perf_counter() - t0)
    else:
      reg.on_dispatch(site)
    return out

  wrapper._glt_instrumented = fn
  wrapper._glt_program_site = site
  for attr in ('_cache_size',):
    val = getattr(fn, attr, None)
    if val is not None:
      setattr(wrapper, attr, val)
  return wrapper


# ----------------------------------------------------------- retrace budget


@contextlib.contextmanager
def retrace_budget(site: str, n: int,
                   registry: Optional[ProgramRegistry] = None):
  """Assert at most ``n`` compiles at ``site`` inside the region.

  The production form of the test-only "one executable per chunk
  length" asserts: a region that compiles more than budgeted RAISES
  :class:`RetraceBudgetExceeded` under ``GLT_STRICT`` and warns
  otherwise, and the message carries the last compile's signature diff
  — the argument whose shape/dtype/sharding drifted. Budget ``n`` is
  the number of compiles the region may legitimately pay (0 for a
  steady-state region whose programs must all already exist)."""
  reg = registry or _default
  base = reg.compile_count(site)
  yield
  extra = reg.compile_count(site) - base
  if extra <= n:
    return
  ev = reg.last_compile(site)
  why = f'last retrace: {ev.diff}' if ev is not None else 'no event'
  msg = (f'retrace budget exceeded at site {site!r}: {extra} compile(s) '
         f'in this region, budget {n}; {why}')
  from . import registry as _reg
  _reg.default_registry().inc('program.retrace_budget_exceeded')
  from ..utils.strict import strict_enabled
  if strict_enabled():
    raise RetraceBudgetExceeded(msg)
  warnings.warn(msg, RuntimeWarning, stacklevel=3)


# -------------------------------------------------------- module-level API


def compile_count(site: Optional[str] = None) -> int:
  return _default.compile_count(site)


def retrace_count(site: Optional[str] = None) -> int:
  return _default.retrace_count(site)


def last_compile(site: str) -> Optional[CompileEvent]:
  return _default.last_compile(site)


def stats() -> Dict[str, Any]:
  return _default.stats()


def aggregate() -> dict:
  return _default.aggregate()


def flight_snapshot() -> Dict[str, dict]:
  return _default.flight_snapshot()
