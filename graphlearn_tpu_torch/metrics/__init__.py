"""graphlearn_tpu_torch.metrics: the observability layer.

The port's copy of ``graphlearn_tpu/metrics`` (pure stdlib, the same
record schemas and environment variables):

* a typed, thread-safe, process-local metric registry — Counter /
  Gauge / Histogram with fixed log-spaced buckets and p50/p95/p99
  estimation (``registry``); ``utils.trace.counter_inc`` and friends
  write into it;
* cross-process scraping — ``scrape_all()`` assembles role-labelled
  snapshots from this process, registered local sources, and every
  connected sampling server (``DistServer.get_metrics`` RPC + producer
  worker snapshots), ``merge_scrape`` folds them into one cluster view;
* the epoch flight recorder (``flight``) — one JSONL record per epoch
  to ``GLT_RUN_LOG``;
* the program observatory (``programs``) — CUDA graph captures (the
  port's compiles) and recaptures with signature diffs at every chunked
  trainer's dispatch site, plus the ``retrace_budget`` guard rail;
* correlated spans (``spans``) — host-clock begin/end records with a
  ``run_id``/request-id context propagated over RPC frames (byte-for-
  byte JAX's, so a trace crosses between the packages), the mp worker
  command queue and ``ServingEngine.submit``, recoverable across
  processes from ``scrape_all()`` + ``GLT_SPAN_LOG``;
* ``logcheck`` — the records' schema check
  (``python -m graphlearn_tpu_torch.metrics.logcheck``).

Metric and span names form a closed namespace
(``registry_names.REGISTERED_METRICS`` / ``REGISTERED_SPANS``).

Idiomatic call forms::

    from graphlearn_tpu_torch import metrics
    metrics.inc('resilience.retry')
    metrics.observe('rpc.client.request_ms', dt_ms)
    metrics.set_gauge('serving.queue_depth', n)
    metrics.snapshot()           # this process
    metrics.scrape_all()         # the cluster, role-labelled
"""
from . import flight, programs, spans
from .programs import (ProgramRegistry, RetraceBudgetExceeded,
                       default_program_registry, instrument,
                       retrace_budget)
from .registry import (BUCKET_SCHEMA, HIST_BOUNDS, Counter, Gauge,
                       Histogram, MetricRegistry, default_registry,
                       merge_snapshots, quantile_from_state)
from .registry_names import REGISTERED_METRICS, REGISTERED_SPANS
from .scrape import (merge_scrape, register_source, scrape_all,
                     unregister_source)


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
