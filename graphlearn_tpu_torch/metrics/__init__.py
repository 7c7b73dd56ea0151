"""graphlearn_tpu_torch.metrics: the process-local metric registry.

The port's copy of the registry half of ``graphlearn_tpu/metrics``:
typed Counter / Gauge / Histogram with the same fixed log-spaced buckets,
and the module-level write forms the serving engine reports through::

    from graphlearn_tpu_torch import metrics
    metrics.inc('serving.requests')
    metrics.observe('serving.total_ms', dt_ms)
    metrics.snapshot()

Spans, the flight recorder, the program observatory, scraping, the log
checker and the closed name list come with the tooling slice.
"""
from .registry import (BUCKET_SCHEMA, HIST_BOUNDS, Counter, Gauge,
                       Histogram, MetricRegistry, default_registry,
                       merge_snapshots, quantile_from_state)


def counter(name: str) -> Counter:
  return default_registry().counter(name)


def gauge(name: str) -> Gauge:
  return default_registry().gauge(name)


def histogram(name: str) -> Histogram:
  return default_registry().histogram(name)


def inc(name: str, n: int = 1):
  default_registry().inc(name, n)


def set_gauge(name: str, value: float):
  default_registry().set_gauge(name, value)


def observe(name: str, value: float):
  default_registry().observe(name, value)


def snapshot() -> dict:
  return default_registry().snapshot()


def reset(prefix: str = ''):
  default_registry().reset(prefix)
