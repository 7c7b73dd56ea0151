"""Deterministic fault injection for the distributed sampling path.

The port's copy of ``graphlearn_tpu/utils/faults.py`` (pure Python).
Named ``fault_point(name)`` sites are threaded through rpc / channel /
server / producer code. In production every site is a no-op: the fast
path is a single falsy check on the module-level registry, and nothing
else runs. In tests a site is armed either in-process via :func:`arm` /
:func:`injected`, or across process boundaries via the ``GLT_FAULTS``
environment variable, which spawned subprocesses (sampling workers,
server processes) inherit and parse at import.

``GLT_FAULTS`` grammar (';'-separated specs)::

    name:kind[:key=val[,key=val...]]

    kinds:  raise  — raise FaultError (or ``exc=ConnectionError`` etc.)
            delay  — sleep ``delay`` seconds (default 1.0)
            exit   — os._exit(``code``) (default 1): a hard crash, no
                     cleanup, the closest stand-in for SIGKILL that can
                     be armed from inside the victim
            drop   — fault_point returns 'drop'; the site decides what
                     dropping means (skip a send, discard a frame)

    keys:   times=N — fire at most N times (default: unlimited)
            after=K — skip the first K hits, then start firing (lets a
                      test kill a worker exactly at batch K)
            delay=S, code=N, exc=NAME (builtin exception name)

Example: kill a sampling worker at its 4th batch, once::

    GLT_FAULTS='producer.worker.batch:exit:after=3,times=1,code=17'

Every firing increments the ``fault.<name>`` trace counter
(``utils/trace.py``), so chaos tests can assert a fault actually fired.
"""
import builtins
import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

logger = logging.getLogger('graphlearn_tpu_torch.faults')

_ENV_VAR = 'GLT_FAULTS'

# The closed inventory of fault sites, JAX's list. Names are
# '<layer>.<operation>', one name per code site.
REGISTERED_SITES = frozenset({
    'rpc.client.request',
    'rpc.client.response',
    'rpc.server.dispatch',
    'channel.remote.fetch',
    'channel.shm.send',
    'server.create_producer',
    'server.fetch',
    'producer.worker.batch',
    'heartbeat.probe',
    'storage.stage',
    'storage.promote',
    'storage.dist_stage',
    'serving.rotate',
    'remote.block_stage',
    'remote.block_fetch',
    'recovery.save',
    'recovery.restore',
    'recovery.roll_back',
    'tenant.admit',
    'tenant.throttle',
    'tenant.reap',
    'tune.shadow_retune',
})


class FaultError(RuntimeError):
  """Default exception raised by an armed 'raise' fault point."""


class _Fault:
  __slots__ = ('name', 'kind', 'exc', 'times', 'after', 'delay', 'code',
               'hits', 'fired')

  def __init__(self, name: str, kind: str = 'raise',
               exc: type = FaultError, times: Optional[int] = None,
               after: int = 0, delay: float = 1.0, code: int = 1):
    if kind not in ('raise', 'delay', 'exit', 'drop'):
      raise ValueError(f'unknown fault kind {kind!r}')
    self.name, self.kind, self.exc = name, kind, exc
    self.times, self.after = times, after
    self.delay, self.code = delay, code
    self.hits = 0    # site passages while armed
    self.fired = 0   # actual injections


# name -> _Fault. Empty (falsy) when disarmed — fault_point's fast path.
_active: Dict[str, _Fault] = {}


def fault_point(name: str):
  """Marks a named fault site. No-op unless armed; when armed, may
  raise / sleep / hard-exit, or return ``'drop'`` for the site to act
  on. Call sites pay one falsy check when the registry is empty."""
  if not _active:
    return None
  return _fire(name)


def _fire(name: str):
  """Slow path: only reached when at least one fault is armed."""
  f = _active.get(name)
  if f is None:
    return None
  f.hits += 1
  if f.hits <= f.after:
    return None
  if f.times is not None and f.fired >= f.times:
    return None
  f.fired += 1
  from . import trace
  trace.counter_inc(f'fault.{name}')
  if f.kind == 'raise':
    raise f.exc(f'injected fault at {name!r} '
                f'(hit {f.hits}, firing {f.fired})')
  if f.kind == 'delay':
    time.sleep(f.delay)
    return None
  if f.kind == 'exit':
    os._exit(f.code)
  return 'drop'


def arm(name: str, kind: str = 'raise', **kwargs):
  """Arm a fault site in this process (see module docstring for kinds
  and knobs). Re-arming a name replaces its previous fault."""
  _active[name] = _Fault(name, kind, **kwargs)


def disarm(name: Optional[str] = None):
  """Disarm one site, or everything when ``name`` is None."""
  if name is None:
    _active.clear()
  else:
    _active.pop(name, None)


def armed() -> Dict[str, _Fault]:
  """Snapshot of currently armed faults (for assertions)."""
  return dict(_active)


def stats(name: str):
  """(hits, fired) for an armed site — (0, 0) if not armed."""
  f = _active.get(name)
  return (f.hits, f.fired) if f is not None else (0, 0)


@contextmanager
def injected(name: str, kind: str = 'raise', **kwargs):
  """Scoped arm/disarm for tests."""
  arm(name, kind, **kwargs)
  try:
    yield _active[name]
  finally:
    disarm(name)


def env_spec(*specs: str) -> Dict[str, str]:
  """{'GLT_FAULTS': joined spec} — merge into a subprocess env."""
  return {_ENV_VAR: ';'.join(specs)}


def _parse_env(spec: str):
  """Parse a GLT_FAULTS spec into faults, then arm them all. The parse
  happens FIRST: a malformed later item must not leave a partial
  arming behind (raises before any arm)."""
  parsed = []
  for item in spec.split(';'):
    item = item.strip()
    if not item:
      continue
    parts = item.split(':')
    name, kind = parts[0], (parts[1] if len(parts) > 1 else 'raise')
    kwargs = {}
    if len(parts) > 2 and parts[2]:
      for kv in parts[2].split(','):
        k, sep, v = kv.partition('=')
        if not sep:
          raise ValueError(f'GLT_FAULTS: malformed key=val {kv!r}')
        if k in ('times', 'after', 'code'):
          kwargs[k] = int(v)
        elif k == 'delay':
          kwargs[k] = float(v)
        elif k == 'exc':
          exc = getattr(builtins, v, None)
          if not (isinstance(exc, type) and
                  issubclass(exc, BaseException)):
            raise ValueError(f'GLT_FAULTS: unknown exception {v!r}')
          kwargs['exc'] = exc
        else:
          raise ValueError(f'GLT_FAULTS: unknown key {k!r}')
    parsed.append(_Fault(name, kind, **kwargs))   # validates kind
  for f in parsed:
    _active[f.name] = f


def load_env(spec: Optional[str]) -> bool:
  """Arm faults from a GLT_FAULTS-grammar spec, tolerating garbage: a
  malformed value WARNS and arms nothing (observability/chaos tooling
  must never crash the worker import it rides in on). Returns True when
  the spec armed."""
  if not spec:
    return False
  try:
    _parse_env(spec)
    return True
  except (ValueError, TypeError) as e:
    logger.warning('%s=%r is malformed (%s) — no faults armed; see the '
                   'grammar in utils/faults.py', _ENV_VAR, spec, e)
    return False


load_env(os.environ.get(_ENV_VAR))
