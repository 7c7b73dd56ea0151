"""Typed metric registry: Counter / Gauge / Histogram, process-local.

The port's own copy of ``graphlearn_tpu/metrics/registry.py`` (pure
stdlib). ``HIST_BOUNDS`` and ``BUCKET_SCHEMA`` are unchanged, so a
snapshot of either package bins and merges bucket for bucket with the
other, and percentiles agree on the same observations.

Every mutation and every snapshot takes the owning registry's lock:
increments arrive from the serving engine's dispatcher thread and from
caller threads at once.
"""
import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional

# Histogram buckets: fixed log-spaced upper bounds, 4 per decade over
# 1e-6 .. 1e9. Fixed for life, so snapshots from any process merge bucket
# for bucket; BUCKET_SCHEMA is embedded in every snapshot and checked on
# merge.
BUCKETS_PER_DECADE = 4
_DECADE_LO, _DECADE_HI = -6, 9
HIST_BOUNDS: tuple = tuple(
    10.0 ** (k / BUCKETS_PER_DECADE)
    for k in range(_DECADE_LO * BUCKETS_PER_DECADE,
                   _DECADE_HI * BUCKETS_PER_DECADE + 1))
BUCKET_SCHEMA = f'log10:{BUCKETS_PER_DECADE}/decade:' \
                f'{_DECADE_LO}..{_DECADE_HI}'


class Counter:
  """Monotonic event count."""

  __slots__ = ('name', '_value', '_lock')
  kind = 'counter'

  def __init__(self, name: str, lock: threading.Lock):
    self.name = name
    self._value = 0
    self._lock = lock

  def inc(self, n: int = 1):
    with self._lock:
      self._value += n

  @property
  def value(self) -> int:
    with self._lock:
      return self._value


class Gauge:
  """Last-written instantaneous value."""

  __slots__ = ('name', '_value', '_lock')
  kind = 'gauge'

  def __init__(self, name: str, lock: threading.Lock):
    self.name = name
    self._value = 0.0
    self._lock = lock

  def set(self, value: float):
    with self._lock:
      self._value = float(value)

  @property
  def value(self) -> float:
    with self._lock:
      return self._value


class Histogram:
  """Fixed log-spaced-bucket histogram with quantile estimation.

  ``observe(v)`` drops v into one of ``len(HIST_BOUNDS) + 1`` buckets
  (bucket i holds values <= HIST_BOUNDS[i]; the last is the +inf
  overflow). Quantiles interpolate geometrically inside the matched
  bucket and clamp to the observed min/max, so they land within one
  bucket ratio (10^0.25) of the exact sample quantile. Values <= 0 go to
  the first bucket.
  """

  __slots__ = ('name', '_counts', '_sum', '_count', '_min', '_max',
               '_lock')
  kind = 'histogram'

  def __init__(self, name: str, lock: threading.Lock):
    self.name = name
    self._counts = [0] * (len(HIST_BOUNDS) + 1)
    self._sum = 0.0
    self._count = 0
    self._min: Optional[float] = None
    self._max: Optional[float] = None
    self._lock = lock

  def observe(self, value: float):
    value = float(value)
    i = bisect.bisect_left(HIST_BOUNDS, value) if value > 0 else 0
    with self._lock:
      self._counts[i] += 1
      self._sum += value
      self._count += 1
      if self._min is None or value < self._min:
        self._min = value
      if self._max is None or value > self._max:
        self._max = value

  @property
  def count(self) -> int:
    with self._lock:
      return self._count

  @property
  def sum(self) -> float:
    with self._lock:
      return self._sum

  def state(self) -> dict:
    """Snapshot leaf (see MetricRegistry.snapshot for the schema)."""
    with self._lock:
      return dict(counts=list(self._counts), sum=self._sum,
                  count=self._count, min=self._min, max=self._max,
                  buckets=BUCKET_SCHEMA)

  def quantile(self, q: float) -> Optional[float]:
    return quantile_from_state(self.state(), q)

  def percentiles(self) -> Dict[str, Optional[float]]:
    """{'p50': ..., 'p95': ..., 'p99': ...}."""
    st = self.state()
    return {f'p{int(100 * q)}': quantile_from_state(st, q)
            for q in (0.5, 0.95, 0.99)}


def quantile_from_state(state: dict, q: float) -> Optional[float]:
  """Quantile estimate from a histogram snapshot leaf (merged snapshots
  too)."""
  if not 0.0 <= q <= 1.0:
    raise ValueError(f'quantile must be in [0, 1], got {q}')
  total = state['count']
  if not total:
    return None
  lo_clamp = state['min'] if state['min'] is not None else 0.0
  hi_clamp = state['max'] if state['max'] is not None else float('inf')
  target = q * total
  cum = 0
  for i, c in enumerate(state['counts']):
    if not c:
      continue
    if cum + c >= target:
      # geometric interpolation within bucket (lo, hi]
      frac = (target - cum) / c
      hi = HIST_BOUNDS[i] if i < len(HIST_BOUNDS) else hi_clamp
      lo = HIST_BOUNDS[i - 1] if i > 0 else min(lo_clamp, hi)
      if lo <= 0 or hi <= 0 or not math.isfinite(hi):
        est = hi if math.isfinite(hi) else lo
      else:
        est = lo * (hi / lo) ** frac
      return min(max(est, lo_clamp), hi_clamp)
    cum += c
  return hi_clamp if math.isfinite(hi_clamp) else None


_KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricRegistry:
  """Get-or-create store of named typed metrics. One name maps to one
  metric of one kind; asking for it as another kind raises."""

  def __init__(self):
    self._lock = threading.Lock()
    self._metrics: Dict[str, object] = {}

  def _get(self, name: str, kind: str):
    with self._lock:
      m = self._metrics.get(name)
      if m is None:
        m = self._metrics[name] = _KINDS[kind](name, self._lock)
      elif m.kind != kind:
        raise ValueError(
            f'metric {name!r} already registered as a {m.kind}, '
            f'requested as a {kind} — one name, one type')
      return m

  def counter(self, name: str) -> Counter:
    return self._get(name, 'counter')

  def gauge(self, name: str) -> Gauge:
    return self._get(name, 'gauge')

  def histogram(self, name: str) -> Histogram:
    return self._get(name, 'histogram')

  def inc(self, name: str, n: int = 1):
    self.counter(name).inc(n)

  def set_gauge(self, name: str, value: float):
    self.gauge(name).set(value)

  def observe(self, name: str, value: float):
    self.histogram(name).observe(value)

  def counters(self, prefix: str = '') -> Dict[str, int]:
    """{name: value} for counters matching ``prefix``."""
    with self._lock:
      return {n: m._value for n, m in self._metrics.items()
              if m.kind == 'counter' and n.startswith(prefix)}

  def counter_value(self, name: str) -> int:
    with self._lock:
      m = self._metrics.get(name)
      return m._value if m is not None and m.kind == 'counter' else 0

  def names(self) -> List[str]:
    with self._lock:
      return sorted(self._metrics)

  def snapshot(self) -> dict:
    """Plain-dict snapshot of everything::

        {'counters':   {name: int},
         'gauges':     {name: float},
         'histograms': {name: {'counts': [...], 'sum': float,
                               'count': int, 'min': ..., 'max': ...,
                               'buckets': BUCKET_SCHEMA}}}
    """
    with self._lock:
      out = {'counters': {}, 'gauges': {}, 'histograms': {}}
      for n, m in self._metrics.items():
        if m.kind == 'counter':
          out['counters'][n] = m._value
        elif m.kind == 'gauge':
          out['gauges'][n] = m._value
        else:
          out['histograms'][n] = dict(
              counts=list(m._counts), sum=m._sum, count=m._count,
              min=m._min, max=m._max, buckets=BUCKET_SCHEMA)
      return out

  def reset(self, prefix: str = ''):
    """Drop metrics whose name matches ``prefix`` (all by default)."""
    with self._lock:
      for n in [n for n in self._metrics if n.startswith(prefix)]:
        del self._metrics[n]

  def reset_counters(self, prefix: str = ''):
    """Drop counters matching ``prefix``, leaving gauges/histograms."""
    with self._lock:
      for n in [n for n, m in self._metrics.items()
                if m.kind == 'counter' and n.startswith(prefix)]:
        del self._metrics[n]


def merge_snapshots(snapshots: Iterable[dict]) -> dict:
  """Fold snapshots into one view: counters and histogram buckets add;
  gauges keep the last writer. Histogram leaves must share
  BUCKET_SCHEMA."""
  out: dict = {'counters': {}, 'gauges': {}, 'histograms': {}}
  for snap in snapshots:
    if not snap:
      continue
    for n, v in snap.get('counters', {}).items():
      out['counters'][n] = out['counters'].get(n, 0) + v
    for n, v in snap.get('gauges', {}).items():
      out['gauges'][n] = v
    for n, h in snap.get('histograms', {}).items():
      if h.get('buckets', BUCKET_SCHEMA) != BUCKET_SCHEMA:
        raise ValueError(
            f'histogram {n!r} bucket schema {h.get("buckets")!r} != '
            f'{BUCKET_SCHEMA!r} — snapshots from incompatible builds '
            'cannot be merged')
      acc = out['histograms'].get(n)
      if acc is None:
        out['histograms'][n] = dict(h, counts=list(h['counts']))
        continue
      acc['counts'] = [a + b for a, b in zip(acc['counts'],
                                             h['counts'])]
      acc['sum'] += h['sum']
      acc['count'] += h['count']
      for k, pick in (('min', min), ('max', max)):
        if h[k] is not None:
          acc[k] = h[k] if acc[k] is None else pick(acc[k], h[k])
  return out


# The process-local default registry the module functions write to.
_default = MetricRegistry()


def default_registry() -> MetricRegistry:
  return _default
