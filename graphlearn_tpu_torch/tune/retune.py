"""Continuous retuning: the drift-watching daemon that keeps a tuned
config current as the workload shifts.

Counterpart of ``graphlearn_tpu/tune/retune.py``. A :class:`TuneArtifact`
pins knob choices to the workload they were measured on, and those
choices rot as the graph and the traffic drift. :class:`RetuneScheduler`
is the ``serving.rotation.RotationScheduler`` pattern applied to
configs: a daemon thread polls the observatory's drift signals, and when
one fires it re-runs ``tune()`` on a SHADOW replica (a caller-supplied
``shadow_tune_fn`` that must never touch the serving or training
stream), then publishes the fresh artifact through the same
fingerprint-validated ``config=`` path everything else uses.

Failure semantics mirror rotation's: a failed or crashed shadow retune
(chaos-tested with the ``tune.shadow_retune`` fault) leaves the
previously published config serving untouched — ``publish_fn`` is only
called with a successfully built artifact, and an exception anywhere in
the build/publish pair keeps ``current`` as it was. A drift probe that
RAISES counts as not-drifted.

Triggers are **edge-latched**: a sustained condition fires its retune
once, then re-arms only after the probe reads False again (falling
edge). A FAILED retune re-arms the firing trigger immediately, so a
still-drifted condition retries on the next poll.

Drift-probe factories for the three stock signals, read from the port's
metric registry: retrace-budget overruns
(``program.retrace_budget_exceeded``), feature-cache hit-rate decay
(``dist_feature.hits`` / ``dist_feature.misses``, which the distributed
trainers publish once an epoch) and serving p99 creep
(``serving.total_ms``).
"""
import logging
import threading
import time
from typing import Callable, Dict, Optional

from .. import metrics
from ..metrics import spans
from ..utils.faults import fault_point

logger = logging.getLogger('graphlearn_tpu_torch.tune')


# ---------------------------------------------------------- drift probes


def retrace_overrun_probe() -> Callable[[], bool]:
  """Drifted when ``program.retrace_budget_exceeded`` ADVANCED since
  the last poll — a steady-state program population that starts
  compiling again is the observatory's own signal that the tuned
  shapes no longer fit the workload (metrics/programs.py
  ``retrace_budget``)."""
  src = metrics.counter('program.retrace_budget_exceeded')
  last = [src.value]

  def probe() -> bool:
    now = src.value
    grew = now > last[0]
    last[0] = now
    return grew

  return probe


def hit_rate_decay_probe(floor: float) -> Callable[[], bool]:
  """Drifted when the feature cache's hit rate over the lookups SINCE
  THE LAST POLL fell below ``floor`` — the cached hot set no longer
  matches the access distribution (the DCI drift signal, on the
  headline ``dist_feature.hits`` / ``dist_feature.misses`` counters
  ``publish_stats`` lands once per epoch)."""
  hits_c = metrics.counter('dist_feature.hits')
  miss_c = metrics.counter('dist_feature.misses')
  last = [hits_c.value, miss_c.value]

  def probe() -> bool:
    h, m = hits_c.value, miss_c.value
    dh, dm = h - last[0], m - last[1]
    last[0], last[1] = h, m
    total = dh + dm
    return total > 0 and (dh / total) < floor

  return probe


def p99_creep_probe(limit_ms: float,
                    min_count: int = 1) -> Callable[[], bool]:
  """Drifted when ``serving.total_ms``'s p99 sits above ``limit_ms``
  (with at least ``min_count`` observations — an empty histogram is
  not evidence). The serving tier's own SLO lens, reused as the
  retune trigger."""
  hist = metrics.histogram('serving.total_ms')

  def probe() -> bool:
    if hist.count < min_count:
      return False
    q = hist.quantile(0.99)
    return q is not None and q > limit_ms

  return probe


# ------------------------------------------------------------- scheduler


class RetuneScheduler:
  """Drives shadow retunes off observatory drift signals (module
  docstring; docs/tuning.md 'Continuous retuning').

  Args:
    shadow_tune_fn: ``() -> TuneArtifact`` — runs ``tune()`` on the
      SHADOW replica (a scenario factory over replica resources,
      never the serving/training stream) and returns the fresh
      artifact. Raising keeps the previous config published.
    publish_fn: ``(artifact) -> None`` — installs the artifact through
      the fingerprint-validated ``config=`` path (rebuild a trainer,
      swap a serving engine's config, write the artifact file an
      orchestrator watches). Only ever called with a successfully
      built artifact; raising keeps the previous config.
    triggers: ``{name: () -> bool}`` drift probes (the factories
      above, or any closure). At least one is required. Edge-latched;
      a raising probe counts as not-drifted.
    initial: the currently published artifact, if any — ``current``
      reads it until the first successful retune.
    poll_s: daemon poll cadence.
  """

  def __init__(self, shadow_tune_fn: Callable, publish_fn: Callable,
               triggers: Dict[str, Callable[[], bool]],
               initial=None, poll_s: float = 0.5):
    if not triggers:
      raise ValueError('RetuneScheduler needs at least one drift '
                       'trigger (docs/tuning.md "Continuous '
                       'retuning")')
    self.shadow_tune_fn = shadow_tune_fn
    self.publish_fn = publish_fn
    self.triggers = dict(triggers)
    self.poll_s = float(poll_s)
    self.current = initial       # last successfully PUBLISHED artifact
    self.retunes = 0             # successful shadow-retune publishes
    self.failures = 0            # failed attempts (previous config kept)
    self.last_error: Optional[str] = None
    self.last_trigger: Optional[str] = None
    self._latched = {name: False for name in self.triggers}
    self._stop = threading.Event()
    self._wake = threading.Event()   # stop/retune_now interrupt a poll
    self._thread: Optional[threading.Thread] = None

  _force = False

  # ------------------------------------------------------------ lifecycle

  def start(self) -> 'RetuneScheduler':
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop.clear()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name='gtt-retune-scheduler')
    self._thread.start()
    return self

  def stop(self, timeout: float = 30.0):
    """Signal the loop to exit and join it. An in-flight shadow retune
    completes first — a publish is never abandoned half-installed."""
    self._stop.set()
    self._wake.set()
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)
      if t.is_alive():
        raise TimeoutError(
            f'retune scheduler did not stop within {timeout}s (a '
            'shadow retune is still running; it will finish on the '
            'daemon thread)')
    self._thread = None

  def retune_now(self):
    """Force the next poll to retune regardless of drift signals."""
    self._force = True
    self._wake.set()

  # ----------------------------------------------------------------- loop

  def _fired(self) -> Optional[str]:
    """Poll every probe (all of them — falling edges must re-arm even
    while another trigger fires) and return the first NEWLY drifted
    trigger's name, edge-latched."""
    fired = None
    for name, probe in self.triggers.items():
      try:
        drifted = bool(probe())
      except Exception:  # noqa: BLE001 - a broken probe must not fire a retune
        drifted = False
        logger.exception('retune drift probe %r raised — treating as '
                         'not-drifted', name)
      if drifted:
        if not self._latched[name] and fired is None:
          self._latched[name] = True
          fired = name
      else:
        self._latched[name] = False   # falling edge re-arms
    return fired

  def _attempt(self, trigger: str):
    metrics.inc('tune.drift_triggers')
    t0 = time.perf_counter()
    try:
      with spans.span('tune.retune', trigger=trigger):
        # chaos seam: a killed/crashed shadow retune must leave the
        # live config untouched
        fault_point('tune.shadow_retune')
        art = self.shadow_tune_fn()
        self.publish_fn(art)
      # state flips only AFTER a successful build+publish pair — any
      # exception above leaves `current` exactly as it was
      self._force = False
      self.current = art
      self.retunes += 1
      self.last_error = None
      self.last_trigger = trigger
      metrics.inc('tune.retunes')
      metrics.observe('tune.shadow_wall_ms',
                      (time.perf_counter() - t0) * 1e3)
    except Exception as e:  # noqa: BLE001 - degrade, keep previous config
      self.failures += 1
      self.last_error = f'{type(e).__name__}: {e}'
      if trigger in self._latched:
        # a still-drifted condition should retry on the next poll —
        # the once-per-sustained-condition guarantee counts
        # successful publishes, not attempts
        self._latched[trigger] = False
      logger.warning(
          'shadow retune (trigger %r) failed (%s) — previous config '
          'keeps serving; will retry while the drift persists',
          trigger, self.last_error)

  def _loop(self):
    while not self._stop.is_set():
      trigger = 'forced' if self._force else self._fired()
      if trigger is not None:
        self._attempt(trigger)
      self._wake.wait(self.poll_s)
      self._wake.clear()
