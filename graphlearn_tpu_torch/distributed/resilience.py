"""Resilience primitives for the distributed sampling path.

Counterpart of ``graphlearn_tpu/distributed/resilience.py``:

* :class:`RetryPolicy` — exponential backoff with jitter and two
  deadline budgets (per attempt, total). Retries are only ever applied
  to calls the caller has declared idempotent — re-sending a
  non-idempotent RPC after a lost response duplicates its side effect.

* :class:`Heartbeat` — a liveness tracker. Sampling servers answer a
  ``heartbeat`` RPC (``DistServer.heartbeat``); the remote loaders poll
  it from a background thread per server, so a dead or partitioned
  server is declared dead after ``miss_threshold`` consecutive missed
  probes (seconds) instead of surfacing as a 180 s socket timeout deep
  inside a fetch.

Degradation events are reported through ``utils.trace`` counters
(``resilience.retry``, ``resilience.server_dead``, ...).
"""
import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from ..utils import trace
from ..utils.faults import fault_point

logger = logging.getLogger('graphlearn_tpu_torch.resilience')

# shared jitter source for policies without an explicit seed (process-
# seeded, so independent clients spread their retries apart)
_jitter = random.Random()


def env_float(name: str, default: float,
              minimum: Optional[float] = None) -> float:
  """A float tuning knob from the environment, HARDENED: a malformed
  or out-of-range value warns and falls back to the default — a typo'd
  production override must never crash a worker's import or wedge its
  liveness loop."""
  raw = os.environ.get(name)
  if raw in (None, ''):
    return default
  try:
    val = float(raw)
    if val != val or (minimum is not None and val < minimum):
      raise ValueError('out of range')
  except (TypeError, ValueError):
    logger.warning('%s=%r is not a usable number — using the default '
                   '%s', name, raw, default)
    return default
  return val


def env_int(name: str, default: int, minimum: Optional[int] = None) -> int:
  """Integer counterpart of :func:`env_float` (same fallback rules)."""
  raw = os.environ.get(name)
  if raw in (None, ''):
    return default
  try:
    val = int(raw)
    if minimum is not None and val < minimum:
      raise ValueError('out of range')
  except (TypeError, ValueError):
    logger.warning('%s=%r is not a usable integer — using the default '
                   '%s', name, raw, default)
    return default
  return val


#: Launch-wide heartbeat tuning: probe period
#: and miss threshold for Heartbeat instances constructed without
#: explicit values. Malformed values fall back (env_float/env_int).
ENV_HEARTBEAT_INTERVAL = 'GLT_HEARTBEAT_INTERVAL'
ENV_HEARTBEAT_MISS = 'GLT_HEARTBEAT_MISS'


class DeadlineExceeded(TimeoutError):
  """A RetryPolicy exhausted its attempt or total-deadline budget."""


class ServerDeadError(ConnectionError):
  """A sampling server was declared dead (liveness or hard RPC failure).

  Carries the rank so failover code can redistribute its work."""

  def __init__(self, rank: int, cause: str = ''):
    super().__init__(f'sampling server rank {rank} declared dead'
                     + (f': {cause}' if cause else ''))
    self.rank = rank
    self.cause = cause


@dataclass(frozen=True)
class RetryPolicy:
  """Exponential backoff + jitter + deadline budgets.

  ``base_delay * multiplier**k`` capped at ``max_delay``, each delay
  scaled by ``1 - jitter .. 1``. With ``seed`` set the jitter stream is
  deterministic per delays() call (tests replay the exact schedule);
  with the default ``seed=None`` it draws from a process RNG so
  concurrent retriers desynchronize instead of hammering a recovering
  server in lockstep. ``max_attempts`` bounds tries; ``total_deadline``
  bounds wall time across attempts (checked before sleeping — the
  policy never sleeps past its budget); ``per_attempt_timeout`` is
  advisory for callers that can bound a single attempt (RpcClient maps
  it onto the socket timeout, including connection establishment).
  """
  max_attempts: int = 4
  base_delay: float = 0.05
  max_delay: float = 2.0
  multiplier: float = 2.0
  jitter: float = 0.25
  per_attempt_timeout: Optional[float] = None
  total_deadline: Optional[float] = 30.0
  seed: Optional[int] = None

  def delays(self) -> Iterable[float]:
    """The backoff schedule: one delay per retry (attempts - 1)."""
    rng = random.Random(self.seed) if self.seed is not None else _jitter
    for k in range(self.max_attempts - 1):
      d = min(self.base_delay * (self.multiplier ** k), self.max_delay)
      yield d * (1.0 - self.jitter * rng.random())

  def run(self, fn: Callable, *args,
          retry_on=(ConnectionError, TimeoutError, OSError, EOFError),
          on_retry: Optional[Callable] = None, describe: str = '',
          **kwargs):
    """Call ``fn`` under this policy. Retries on ``retry_on``; any other
    exception propagates immediately. ``on_retry(attempt, exc)`` runs
    before each backoff sleep (loaders use it to refresh connections).
    Raises :class:`DeadlineExceeded` (with the last error chained) when
    the budget is exhausted.
    """
    start = time.monotonic()
    last_err: Optional[BaseException] = None
    attempts_made = 0
    delays = list(self.delays())
    for attempt in range(self.max_attempts):
      if self.total_deadline is not None and \
          time.monotonic() - start > self.total_deadline:
        break
      try:
        attempts_made += 1
        return fn(*args, **kwargs)
      except retry_on as e:  # noqa: PERF203 - retry loop
        last_err = e
        if attempt >= self.max_attempts - 1:
          break
        delay = delays[attempt]
        if self.total_deadline is not None and \
            (time.monotonic() - start) + delay > self.total_deadline:
          break
        trace.counter_inc('resilience.retry')
        if on_retry is not None:
          on_retry(attempt, e)
        logger.warning('%s failed (%s); retrying in %.3fs (attempt %d/%d)',
                       describe or getattr(fn, '__name__', 'call'), e,
                       delay, attempt + 1, self.max_attempts)
        time.sleep(delay)
    if attempts_made <= 1 and last_err is not None:
      # nothing was retried (NO_RETRY or immediate budget exhaustion):
      # surface the ORIGINAL exception type — re-typing a single
      # ConnectionRefusedError as a TimeoutError would steer callers
      # that branch on the class into the wrong recovery path
      raise last_err
    raise DeadlineExceeded(
        f'{describe or getattr(fn, "__name__", "call")} failed after '
        f'{attempts_made} attempt(s) / '
        f'{time.monotonic() - start:.1f}s: {last_err}') from last_err


#: Conservative default used for idempotent control-plane RPCs. The
#: finite per-attempt timeout matters: without it a hung (not dead)
#: server would hold one attempt for the full 180 s socket timeout and
#: the total_deadline would expire after a single try, never retrying.
DEFAULT_RETRY_POLICY = RetryPolicy(per_attempt_timeout=7.0)

#: No retries at all — single attempt, surface the first error.
NO_RETRY = RetryPolicy(max_attempts=1, total_deadline=None)


class Heartbeat:
  """Background liveness probes against a set of server ranks.

  One daemon thread per rank calls ``probe_fn(rank)`` every
  ``interval`` seconds with a bounded per-probe timeout; after
  ``miss_threshold`` consecutive failures the rank is declared dead:
  ``on_dead(rank, cause)`` fires once, ``dead_ranks()`` reports it, and
  probing of that rank stops (death is sticky — a flapping server must
  be re-added explicitly). Detection latency is therefore about
  ``interval * miss_threshold`` seconds, versus the 180 s socket
  timeout on the data path.
  """

  def __init__(self, ranks: Iterable[int], probe_fn: Callable[[int], None],
               interval: Optional[float] = None,
               miss_threshold: Optional[int] = None,
               on_dead: Optional[Callable[[int, str], None]] = None):
    self._ranks: List[int] = list(ranks)
    self._probe = probe_fn
    # None = the launch-wide env defaults (hardened parse: a malformed
    # GLT_HEARTBEAT_* value warns and uses the built-in default)
    if interval is None:
      interval = env_float(ENV_HEARTBEAT_INTERVAL, 1.0, minimum=1e-3)
    if miss_threshold is None:
      miss_threshold = env_int(ENV_HEARTBEAT_MISS, 3, minimum=1)
    self.interval = interval
    self.miss_threshold = max(1, miss_threshold)
    self._on_dead = on_dead
    # liveness state shared between per-rank probe threads and caller
    # threads (is_dead/dead_ranks/mark_dead) — every access holds _lock
    # graftlint: shared[_lock]
    self._dead: Dict[int, str] = {}
    # graftlint: shared[_lock]
    self._misses: Dict[int, int] = {r: 0 for r in self._ranks}
    # graftlint: shared[_lock]
    self._last_ok: Dict[int, float] = {}
    self._stop = threading.Event()
    self._lock = threading.Lock()
    self._threads: List[threading.Thread] = []

  def start(self):
    if self._threads:
      return
    self._stop.clear()
    for rank in self._ranks:
      t = threading.Thread(target=self._loop, args=(rank,), daemon=True,
                           name=f'gtt-heartbeat-{rank}')
      self._threads.append(t)
      t.start()

  def stop(self):
    self._stop.set()
    for t in self._threads:
      t.join(timeout=self.interval + 5)
    self._threads = []

  def _loop(self, rank: int):
    while not self._stop.wait(self.interval):
      with self._lock:
        if rank in self._dead:
          return
      try:
        fault_point('heartbeat.probe')
        self._probe(rank)
      except Exception as e:  # noqa: BLE001 - any failure is a miss
        dead = False
        with self._lock:
          self._misses[rank] += 1
          if self._misses[rank] >= self.miss_threshold and \
              rank not in self._dead:
            self._dead[rank] = repr(e)
            dead = True
        if dead:
          trace.counter_inc('resilience.server_dead')
          logger.warning('server rank %d declared dead after %d missed '
                         'heartbeats: %s', rank, self.miss_threshold, e)
          if self._on_dead is not None:
            try:
              self._on_dead(rank, repr(e))
            except Exception:  # noqa: BLE001 - callback must not kill probe
              logger.exception('heartbeat on_dead callback failed')
          return
      else:
        with self._lock:
          self._misses[rank] = 0
          self._last_ok[rank] = time.monotonic()

  def is_dead(self, rank: int) -> bool:
    with self._lock:
      return rank in self._dead

  def dead_ranks(self) -> Dict[int, str]:
    """{rank: cause} for every rank declared dead so far."""
    with self._lock:
      return dict(self._dead)

  def mark_dead(self, rank: int, cause: str):
    """Externally declare a rank dead (e.g. a hard RPC failure on the
    data path — no need to wait out the probe threshold)."""
    first = False
    with self._lock:
      if rank not in self._dead:
        self._dead[rank] = cause
        first = True
    if first:
      trace.counter_inc('resilience.server_dead')
