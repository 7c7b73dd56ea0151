"""Cluster-wide metric scraping with per-role labels.

The port's copy of ``graphlearn_tpu/metrics/scrape.py``. The production
topology is multi-process: sampling SERVERS own remote producers and
answer RPC, mp PRODUCER workers sample in subprocesses, and the trainer
CLIENT drives epochs.
Each process keeps its own process-local registry;
:func:`scrape_all` assembles the cluster view at the client::

    {'client/0':             <snapshot>,      # this process
     'server/0':             <snapshot>,      # via get_metrics RPC
     'server/0/producer/3':  <snapshot>,      # that server's mp workers
     'producer/1':           <snapshot>}      # locally registered source

The server leg rides ``DistServer.get_metrics`` — a READ-ONLY RPC,
idempotent by construction, so it is scraped with ``idempotent=True``
and survives retry under the fault-injection registry. A server that
fails its scrape contributes an ``{'error': ...}`` entry instead of
poisoning the whole view (monitoring must degrade, never crash the
trainer).

Local sources (client-side mp producers, serving workers)
register a zero-argument callable returning a snapshot via
:func:`register_source`; sources that raise are skipped with a
``metrics.scrape_error`` count.
"""
import threading
from typing import Callable, Dict, Optional

from .registry import default_registry, merge_snapshots

_sources: Dict[str, Callable[[], dict]] = {}
_sources_lock = threading.Lock()


def register_source(role: str, fn: Callable[[], dict]):
  """Attach a local snapshot source under ``role`` (e.g.
  'producer/0'). Re-registering a role replaces its callable."""
  with _sources_lock:
    _sources[role] = fn


def unregister_source(role: str):
  with _sources_lock:
    _sources.pop(role, None)


def _local_role() -> str:
  try:
    from ..distributed.dist_context import get_context
    ctx = get_context()
  except ImportError:       # pragma: no cover - distributed always ships
    ctx = None
  if ctx is None:
    return 'local'
  if ctx.is_server():
    return f'server/{ctx.rank}'
  if ctx.is_client():
    return f'client/{ctx.rank}'
  return f'worker/{ctx.rank}'


def scrape_all(include_local: bool = True,
               timeout: Optional[float] = 10.0) -> Dict[str, dict]:
  """{role: snapshot} across this process, registered local sources,
  and every connected sampling server (plus their producers' mp
  workers). Server snapshots come over the retry-safe ``get_metrics``
  RPC; unreachable servers yield ``{'error': ...}`` entries.

  ``timeout`` bounds each RPC attempt (seconds). The default is
  deliberately short of the 180 s socket default: a partitioned
  (blackholed, no RST) server must degrade to its error entry in
  seconds, not stall every healthy server's snapshot behind a dead
  connect. Pass None to fall back to the retry policy's budget."""
  from . import spans as _spans
  out: Dict[str, dict] = {}
  if include_local:
    snap = default_registry().snapshot()
    # run_id + span ring ride the snapshot as extra keys (ignored by
    # merge_snapshots): a scrape, a flight record and a span tree from
    # the same run join on run_id, and spans.from_scrape() recovers a
    # request's spans from the scrape result by id alone
    snap['run_id'] = _spans.run_id()
    snap['spans'] = _spans.export(limit=_spans.SCRAPE_EXPORT_LIMIT)
    out[_local_role()] = snap
  with _sources_lock:
    sources = dict(_sources)
  for role, fn in sources.items():
    try:
      snap = fn()
    except Exception as e:  # noqa: BLE001 - monitoring must degrade
      default_registry().inc('metrics.scrape_error')
      out[role] = {'error': f'{type(e).__name__}: {e}'}
      continue
    if snap:
      out[role] = snap
  from ..distributed import dist_client
  client = dist_client.get_client()
  if client is None:
    return out
  # fan the server legs out concurrently (the RpcClient's own pool):
  # per-leg timeouts must not ADD UP — three blackholed servers in a
  # 16-server scrape would otherwise stall every healthy leg behind
  # them for attempts x timeout each
  futures = {rank: client.request_async(rank, 'get_metrics',
                                        timeout=timeout,
                                        idempotent=True)
             for rank in client.targets}
  for rank, fut in futures.items():
    try:
      remote = fut.result()
    except Exception as e:  # noqa: BLE001 - a dead server is a data point
      default_registry().inc('metrics.scrape_error')
      out[f'server/{rank}'] = {'error': f'{type(e).__name__}: {e}'}
      continue
    out[f'server/{rank}'] = remote.get('server', {})
    for pid, snap in remote.get('producers', {}).items():
      out[f'server/{rank}/producer/{pid}'] = snap
  return out


def merge_scrape(scrapes: Dict[str, dict]) -> dict:
  """One cluster-wide snapshot from a :func:`scrape_all` result
  (error entries are skipped). Counters and histogram buckets add
  across roles; see registry.merge_snapshots."""
  return merge_snapshots(
      s for s in scrapes.values() if s and 'error' not in s)
