"""Multi-tenant service plane for the sampling cluster.

The port's copy of ``graphlearn_tpu/distributed/tenancy.py`` (host-only
Python, copied rather than imported, so the port never imports the JAX
package). Several trainers, the embedding materializer and online
serving refreshes contend for the same ``DistServer``s; this module
turns that contention into a bounded, observable condition:

* **Tenant model.** Every producer and block-stream registration carries
  a tenant id, a priority class (``interactive`` > ``training`` >
  ``bulk``) and a fair-share weight. Unknown tenants register under the
  config's default spec, so single-tenant deployments run unchanged.
* **Admission control** (:class:`AdmissionController`): per-tenant
  quotas bound concurrent producers, shm ring bytes and in-flight block
  bytes, enforced at producer creation and in the ``block_*`` RPC
  handlers (``dist_server.py``). An over-quota request raises a typed,
  retryable :class:`TenantQuotaExceeded` / :class:`TenantThrottled` that
  crosses the RPC as a structured payload (``rpc.register_wire_error``)
  and is rebuilt as its class on the client.
* **Weighted-fair scheduling** (:class:`WeightedFairScheduler`): the
  server's block build/fetch lane drains by deficit-weighted round robin
  over tenants under strict priority, so throughput under contention
  splits by weight rather than by arrival order.
* **Visible backpressure** (:func:`with_backpressure`): clients wrap
  throttle-prone RPCs in a bounded exponential backoff that records each
  wait in the ``tenant.backpressure_ms`` histogram; when the budget runs
  out the tenant fails loudly (:class:`TenantStarvedError`, with its
  quota state) instead of stalling.

The scheduler and the admission state run on the sampling servers' RPC
threads and touch no device. A client's throttle wait is a
``tenant.throttle`` span.
"""
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import metrics
from ..metrics import spans
from ..utils.faults import fault_point
from .rpc import register_wire_error

#: strict preemption order: an interactive tenant's queued work is
#: always granted before any training work, which preempts bulk
PRIORITY_CLASSES = ('interactive', 'training', 'bulk')

_DEFAULT_TENANT = 'default'


def _priority_index(priority: str) -> int:
  try:
    return PRIORITY_CLASSES.index(priority)
  except ValueError:
    raise ValueError(
        f'unknown priority class {priority!r}; expected one of '
        f'{PRIORITY_CLASSES}') from None


@dataclass(frozen=True)
class TenantSpec:
  """One tenant's contract with the cluster. ``None`` quota fields are
  unlimited; ``producer_ttl`` overrides the server-wide ttl for this
  tenant's producers (one vanished client reaps only its own
  streams)."""
  tenant: str = _DEFAULT_TENANT
  priority: str = 'training'
  weight: float = 1.0
  max_producers: Optional[int] = None
  max_ring_bytes: Optional[int] = None
  max_inflight_bytes: Optional[int] = None
  producer_ttl: Optional[float] = None

  def __post_init__(self):
    _priority_index(self.priority)
    if not self.weight > 0:
      raise ValueError(f'tenant {self.tenant!r}: weight must be > 0, '
                       f'got {self.weight}')


@dataclass
class TenancyConfig:
  """Server-side tenancy configuration (DistServer(tenancy=...)).

  ``specs`` seeds the known tenants; unknown tenants auto-register
  from ``default_spec`` (so turning tenancy on never hard-rejects a
  legacy client). ``sched_timeout`` bounds how long a queued build
  waits for its fair-share grant before the server answers with a
  retryable :class:`TenantThrottled` — the scheduler's backpressure
  valve. ``quantum`` is the DWRR deficit refill per visit, in cost
  units (batches)."""
  specs: List[TenantSpec] = field(default_factory=list)
  default_spec: TenantSpec = field(default_factory=TenantSpec)
  sched_timeout: float = 30.0
  quantum: float = 4.0


class TenantRejection(RuntimeError):
  """Base of the typed, RETRYABLE tenancy rejections. Crosses the RPC
  wire as ``(etype, payload)`` (rpc.py) and reconstructs client-side,
  so loaders can distinguish 'back off and retry' from genuine remote
  failures. Deliberately NOT a ConnectionError/TimeoutError/OSError:
  request_sync's blind retry_on and the remote-scan dead-server
  classifier (_DEAD_EXCS) must both ignore it — backoff happens at the
  tenancy-aware layer (:func:`with_backpressure`), visibly."""

  WIRE_TYPE = 'TenantRejection'
  retryable = True

  def __init__(self, tenant: str, resource: str, message: str,
               quota: Optional[dict] = None,
               retry_after: Optional[float] = None):
    super().__init__(
        f'tenant {tenant!r} {message} (resource={resource}, '
        f'quota={quota})')
    self.tenant = tenant
    self.resource = resource
    self.message = message
    self.quota = dict(quota or {})
    self.retry_after = retry_after

  def to_wire(self) -> dict:
    return dict(tenant=self.tenant, resource=self.resource,
                message=self.message, quota=self.quota,
                retry_after=self.retry_after)

  @classmethod
  def from_wire(cls, payload: dict) -> 'TenantRejection':
    return cls(payload.get('tenant', _DEFAULT_TENANT),
               payload.get('resource', '?'),
               payload.get('message', 'rejected'),
               quota=payload.get('quota'),
               retry_after=payload.get('retry_after'))


class TenantQuotaExceeded(TenantRejection):
  """Admission rejection: a hard per-tenant quota (concurrent
  producers, ring bytes) is full. Retryable — the quota frees when the
  tenant destroys (or the reaper reaps) a producer."""

  WIRE_TYPE = 'TenantQuotaExceeded'


class TenantThrottled(TenantRejection):
  """Flow-control rejection: in-flight block bytes over quota, or the
  fair-share grant did not arrive within ``sched_timeout``. Retryable
  by design — this is the visible form of backpressure."""

  WIRE_TYPE = 'TenantThrottled'


class TenantStarvedError(RuntimeError):
  """Raised CLIENT-side when a tenant's backpressure budget is
  exhausted: the loud failure mode for a permanently-starved tenant,
  carrying the last quota snapshot the server reported (the
  issue-the-operator-can-act-on contract — never a silent stall or an
  opaque QueueTimeoutError)."""

  def __init__(self, describe: str, last: TenantRejection,
               waited_s: float):
    super().__init__(
        f'{describe}: tenant {last.tenant!r} starved — backpressure '
        f'budget exhausted after {waited_s:.1f}s of throttle waits; '
        f'last rejection: {last.message} (resource={last.resource}, '
        f'quota={last.quota})')
    self.tenant = last.tenant
    self.quota = dict(last.quota)
    self.waited_s = waited_s


for _cls in (TenantRejection, TenantQuotaExceeded, TenantThrottled):
  register_wire_error(_cls.WIRE_TYPE, _cls.from_wire)


# --------------------------------------------------------------- admission


class AdmissionController:
  """Per-tenant quota accounting + the pid→tenant map (dist_server
  wiring). All methods are thread-safe; raises are typed/retryable."""

  def __init__(self, config: Optional[TenancyConfig] = None):
    self.config = config or TenancyConfig()
    self._lock = threading.Lock()
    self._specs: Dict[str, TenantSpec] = {
        s.tenant: s for s in self.config.specs}
    self._pid_tenant: Dict[int, str] = {}
    self._pid_ring: Dict[int, int] = {}
    self._inflight: Dict[str, int] = {}
    self._reaped_pids: Dict[int, str] = {}   # tombstones for diagnostics

  # ------------------------------------------------------------- specs

  def register(self, tenant: str, priority: Optional[str] = None,
               weight: Optional[float] = None) -> TenantSpec:
    """Fetch-or-create the tenant's spec, applying any explicit
    priority/weight override (the ``update_tenant`` RPC and the
    create-time registration both land here)."""
    import dataclasses
    with self._lock:
      spec = self._specs.get(tenant)
      if spec is None:
        spec = dataclasses.replace(self.config.default_spec,
                                   tenant=tenant)
      changes = {}
      if priority is not None and priority != spec.priority:
        changes['priority'] = priority
      if weight is not None and weight != spec.weight:
        changes['weight'] = weight
      if changes:
        spec = dataclasses.replace(spec, **changes)
      self._specs[tenant] = spec
      return spec

  def spec(self, tenant: str) -> TenantSpec:
    with self._lock:
      s = self._specs.get(tenant)
    return s if s is not None else self.register(tenant)

  def tenant_of(self, pid: int) -> str:
    with self._lock:
      return self._pid_tenant.get(
          pid, self._reaped_pids.get(pid, _DEFAULT_TENANT))

  def ttl_for_pid(self, pid: int,
                  default: Optional[float]) -> Optional[float]:
    """The reap threshold for this producer: its tenant's
    ``producer_ttl`` when set, else the server-wide default."""
    spec = self.spec(self.tenant_of(pid))
    return spec.producer_ttl if spec.producer_ttl is not None \
        else default

  def min_ttl(self, default: Optional[float]) -> Optional[float]:
    """The smallest armed ttl (reaper poll cadence); None when no ttl
    is armed anywhere."""
    with self._lock:
      ttls = [s.producer_ttl for s in self._specs.values()
              if s.producer_ttl is not None]
    if self.config.default_spec.producer_ttl is not None:
      ttls.append(self.config.default_spec.producer_ttl)
    if default is not None:
      ttls.append(default)
    return min(ttls) if ttls else None

  # --------------------------------------------------------- admission

  def snapshot(self, tenant: str) -> dict:
    """This tenant's quota state — rides every rejection and the
    stale-handle/starvation errors (the operator-actionable context)."""
    spec = self.spec(tenant)
    with self._lock:
      pids = [p for p, t in self._pid_tenant.items() if t == tenant]
      ring = sum(self._pid_ring.get(p, 0) for p in pids)
      inflight = self._inflight.get(tenant, 0)
    return dict(tenant=tenant, priority=spec.priority,
                weight=spec.weight, producers=len(pids),
                max_producers=spec.max_producers, ring_bytes=ring,
                max_ring_bytes=spec.max_ring_bytes,
                inflight_bytes=inflight,
                max_inflight_bytes=spec.max_inflight_bytes,
                producer_ttl=spec.producer_ttl)

  def snapshot_all(self) -> Dict[str, dict]:
    with self._lock:
      tenants = set(self._specs) | set(self._pid_tenant.values())
    return {t: self.snapshot(t) for t in sorted(tenants)}

  def describe_pid(self, pid: int) -> str:
    """Context suffix for stale-handle errors: tenant + quota snapshot
    (satellite: never a bare 'producer unknown')."""
    tenant = self.tenant_of(pid)
    reaped = pid in self._reaped_pids
    return (f' [tenant={tenant!r}'
            f'{" (idle-reaped)" if reaped else ""}, '
            f'quota={self.snapshot(tenant)}]')

  def admit_producer(self, tenant: str, pid: int, ring_bytes: int = 0,
                     priority: Optional[str] = None,
                     weight: Optional[float] = None):
    """Admission gate for producer creation (sampling AND block): the
    ``tenant.admit`` fault site lives here; over-quota raises the
    typed, retryable :class:`TenantQuotaExceeded` with the quota
    snapshot aboard."""
    fault_point('tenant.admit')
    spec = self.register(tenant, priority=priority, weight=weight)
    snap = self.snapshot(tenant)
    if spec.max_producers is not None and \
        snap['producers'] >= spec.max_producers:
      metrics.inc('tenant.admit_rejections')
      raise TenantQuotaExceeded(
          tenant, 'producers',
          f'at its concurrent-producer quota '
          f'({snap["producers"]}/{spec.max_producers})', quota=snap)
    if spec.max_ring_bytes is not None and \
        snap['ring_bytes'] + ring_bytes > spec.max_ring_bytes:
      metrics.inc('tenant.admit_rejections')
      raise TenantQuotaExceeded(
          tenant, 'ring_bytes',
          f'would exceed its shm ring quota '
          f'({snap["ring_bytes"]} + {ring_bytes} > '
          f'{spec.max_ring_bytes})', quota=snap)
    with self._lock:
      self._pid_tenant[pid] = tenant
      if ring_bytes:
        self._pid_ring[pid] = int(ring_bytes)

  def release_producer(self, pid: int, reaped: bool = False):
    with self._lock:
      tenant = self._pid_tenant.pop(pid, None)
      self._pid_ring.pop(pid, None)
      if tenant is not None and reaped:
        self._reaped_pids[pid] = tenant
    return tenant

  # ------------------------------------------------- in-flight bytes

  def check_inflight(self, tenant: str):
    """The produce-ahead throttle: a tenant whose staged-but-unfetched
    block bytes are at quota gets a retryable TenantThrottled (the
    client's fetch of the resident frame is never blocked — fetching
    DRAINS the quota)."""
    spec = self.spec(tenant)
    if spec.max_inflight_bytes is None:
      return
    with self._lock:
      used = self._inflight.get(tenant, 0)
    if used >= spec.max_inflight_bytes:
      metrics.inc('tenant.throttled')
      raise TenantThrottled(
          tenant, 'inflight_bytes',
          f'throttled: {used} staged block bytes >= quota '
          f'{spec.max_inflight_bytes} — fetch staged blocks (or wait) '
          'before producing ahead', quota=self.snapshot(tenant),
          retry_after=0.05)

  def charge_inflight(self, tenant: str, nbytes: int):
    with self._lock:
      self._inflight[tenant] = self._inflight.get(tenant, 0) \
          + int(nbytes)

  def release_inflight(self, tenant: str, nbytes: int):
    with self._lock:
      self._inflight[tenant] = max(
          0, self._inflight.get(tenant, 0) - int(nbytes))


# --------------------------------------------------------------- scheduling


class _Ticket:
  __slots__ = ('cost', 'granted', 'done')

  def __init__(self, cost: float):
    self.cost = float(cost)
    self.granted = threading.Event()
    self.done = threading.Event()


class WeightedFairScheduler:
  """Deficit-weighted round-robin over tenants with strict priority
  preemption — the server-side block work lane (docs/multi_tenancy.md).

  Callers enqueue a ticket and block until the drain thread grants it;
  exactly one grant is outstanding at a time, so the granted caller
  owns the build lane and signals ``done`` when its work finishes.
  Grant order: the highest priority class with queued work always
  wins (an interactive ticket enqueued behind a bulk backlog is
  granted next — strict preemption of the BACKLOG; a running build is
  never interrupted); within a class, classic DRR — each visited
  tenant's deficit grows by ``quantum * weight`` and its head ticket
  is granted once the deficit covers its cost, so long-run throughput
  splits by weight.

  A ticket not granted within ``timeout`` raises the retryable
  :class:`TenantThrottled` — scheduler wait IS backpressure, and the
  client's bounded backoff (:func:`with_backpressure`) makes it
  visible instead of letting the RPC hang."""

  def __init__(self, admission: AdmissionController,
               quantum: float = 4.0, timeout: float = 30.0):
    self._admission = admission
    self.quantum = float(quantum)
    self.timeout = float(timeout)
    self._lock = threading.Lock()
    self._wake = threading.Condition(self._lock)
    # DRR state shared between caller threads (run/close) and the
    # grant thread (_drain/_pick) — guarded by _lock; _wake is a
    # Condition WRAPPING _lock, so waiting on it holds the same lock
    # per priority class: tenant -> deque of tickets (FIFO per tenant)
    # graftlint: shared[_lock]
    self._queues: Dict[int, Dict[str, List[_Ticket]]] = {
        i: {} for i in range(len(PRIORITY_CLASSES))}
    # graftlint: shared[_lock]
    self._deficit: Dict[str, float] = {}
    # graftlint: shared[_lock]
    self._rr: Dict[int, int] = {i: 0 for i in range(len(PRIORITY_CLASSES))}
    self.served: Dict[str, float] = {}   # granted cost per tenant
    self._stop = False
    self._thread = threading.Thread(target=self._drain, daemon=True,
                                    name='gtt-tenant-sched')
    self._thread.start()

  def close(self):
    with self._lock:
      self._stop = True
      self._wake.notify_all()
    self._thread.join(timeout=5.0)

  def run(self, tenant: str, cost: float, fn: Callable,
          timeout: Optional[float] = None):
    """Run ``fn`` under this tenant's fair-share grant. Blocks until
    granted (bounded), runs ``fn`` on the CALLING thread (results and
    errors propagate naturally), then releases the lane."""
    spec = self._admission.spec(tenant)
    prio = _priority_index(spec.priority)
    ticket = _Ticket(cost)
    t0 = time.perf_counter()
    with self._lock:
      self._queues[prio].setdefault(tenant, []).append(ticket)
      self._wake.notify_all()
    if not ticket.granted.wait(self.timeout if timeout is None
                               else timeout):
      with self._lock:
        q = self._queues[prio].get(tenant)
        if q is not None and ticket in q:
          q.remove(ticket)
      # the grant may have raced the timeout: _pick pops under the
      # lock but sets `granted` after releasing it, so give a ticket
      # that is no longer queued a beat to show its grant — if it DID
      # arrive, the lane is ours and must be released normally
      if not ticket.granted.wait(0.1):
        metrics.inc('tenant.throttled')
        raise TenantThrottled(
            tenant, 'schedule',
            f'throttled: no fair-share grant within '
            f'{timeout if timeout is not None else self.timeout}s '
            '(higher-priority/weight tenants hold the block lane)',
            quota=self._admission.snapshot(tenant), retry_after=0.1)
    metrics.observe('tenant.sched_wait_ms',
                    (time.perf_counter() - t0) * 1e3)
    try:
      return fn()
    finally:
      ticket.done.set()
      with self._lock:
        self.served[tenant] = self.served.get(tenant, 0.0) + ticket.cost
        self._wake.notify_all()

  def set_weight(self, tenant: str, weight: float):
    self._admission.register(tenant, weight=weight)

  # ------------------------------------------------------------ drain

  # graftlint: locked[_lock]
  def _pick(self) -> Optional[_Ticket]:
    """Next ticket under the lock, or None when nothing is runnable.
    Strict priority first; DRR within the class."""
    for prio in range(len(PRIORITY_CLASSES)):
      tenants = sorted(t for t, q in self._queues[prio].items() if q)
      if not tenants:
        continue
      # Classic DRR, one grant per call: the cursor tenant keeps the
      # lane while its deficit covers its head ticket; an unaffordable
      # head refills ONCE (quantum * weight) and passes the cursor on.
      # Refilling only on the unaffordable visit is load-bearing —
      # topping up every visited tenant before the affordability check
      # makes any quantum >= cost degenerate to plain round-robin,
      # with the weights ignored.
      start = self._rr[prio]
      n = len(tenants)
      for visit in itertools.count():
        t = tenants[(start + visit) % n]
        head = self._queues[prio][t][0]
        if self._deficit.get(t, 0.0) >= head.cost or visit >= 64 * n:
          # past the defensive cap (huge cost vs tiny weights), grant
          # the current head regardless so the lane cannot wedge
          self._deficit[t] = self._deficit.get(t, 0.0) - head.cost
          self._queues[prio][t].pop(0)
          if not self._queues[prio][t]:
            del self._queues[prio][t]
            # an emptied tenant forfeits its leftover deficit: an idle
            # tenant must not hoard service credit into its next burst
            self._deficit.pop(t, None)
          self._rr[prio] = (start + visit) % n
          return head
        w = max(self._admission.spec(t).weight, 1e-3)
        self._deficit[t] = self._deficit.get(t, 0.0) + self.quantum * w
    return None

  def _drain(self):
    while True:
      with self._lock:
        while not self._stop:
          ticket = self._pick()
          if ticket is not None:
            break
          self._wake.wait(timeout=0.5)
        if self._stop:
          return
      ticket.granted.set()
      # one grant outstanding: wait for the caller to finish its build
      # (or vanish — the done wait is bounded so a killed client
      # thread cannot wedge every other tenant's lane forever)
      ticket.done.wait(timeout=120.0)


# ------------------------------------------------------------ backpressure


def with_backpressure(fn: Callable, describe: str = '',
                      budget_s: float = 120.0,
                      base_delay: float = 0.05,
                      max_delay: float = 2.0,
                      tenant: Optional[str] = None,
                      on_reject: Optional[Callable] = None):
  """Run ``fn()``, absorbing typed tenancy rejections with a bounded
  exponential backoff — the client half of the backpressure contract.

  Every throttle episode records its wait in ``tenant.backpressure_ms``
  and a ``tenant.throttle`` span carrying the tenant and the rejected
  resource, parented under whatever span is current (the epoch root on
  the dispatch thread; the stager worker adopts the epoch context).
  When the cumulative wait exceeds ``budget_s`` the tenant fails
  LOUDLY: :class:`TenantStarvedError` with the server's last quota
  snapshot aboard — never a silent stall, never an opaque
  QueueTimeoutError (docs/multi_tenancy.md)."""
  waited = 0.0
  attempt = 0
  while True:
    try:
      return fn()
    except TenantRejection as e:
      fault_point('tenant.throttle')
      if on_reject is not None:
        on_reject(e)
      delay = e.retry_after if e.retry_after is not None \
          else base_delay * (2 ** attempt)
      delay = min(max(delay, base_delay), max_delay)
      if waited + delay > budget_s:
        metrics.inc('tenant.starved')
        raise TenantStarvedError(describe or 'backpressured call',
                                 e, waited) from e
      t0 = time.perf_counter()
      with spans.span('tenant.throttle',
                      tenant=str(tenant or e.tenant),
                      resource=e.resource, attempt=attempt):
        time.sleep(delay)
      wait_ms = (time.perf_counter() - t0) * 1e3
      metrics.observe('tenant.backpressure_ms', wait_ms)
      waited += delay
      attempt += 1
