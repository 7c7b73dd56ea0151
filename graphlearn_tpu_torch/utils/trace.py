"""Event counters over the metric registry.

The counter half of ``graphlearn_tpu/utils/trace.py``: ``counter_inc``,
``counter_get``, ``counters`` and ``reset_counters`` read and write the
counters of the port's ``metrics`` registry, so they appear in
``metrics.snapshot()`` beside gauges and histograms. The resilience
layer (``resilience.retry``, ``resilience.server_dead``, ...) and the
fault registry (``fault.<site>``) report through them. The profiler half
(trace capture, annotations, dispatch counting) comes with the tooling
slice.
"""

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
