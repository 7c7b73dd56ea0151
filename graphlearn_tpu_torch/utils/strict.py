"""Strict runtime guard rails for the chunked-epoch hot paths.

Counterpart of ``graphlearn_tpu/utils/strict.py``. ``GLT_STRICT=1``
turns the hot-path contract (an epoch enqueues work and reads nothing
back until it ends) into a runtime tripwire: the regions JAX guards run
under :func:`strict_guards`, which on a card sets
``torch.cuda.set_sync_debug_mode('error')``, so a host sync inside the
region (``.item()``, ``.cpu()``, a pageable copy, a ``nonzero``) raises
instead of silently bringing back the per-step sync the chunked epoch
exists to remove. The previous mode is restored on exit, nesting
included.

The six regions, as JAX's (the seed build, the chunk loop and the
metrics concat; never the epoch-boundary bookkeeping, which is the
overflow-policy fetch and the stats publish):

- ``loader.ScanTrainer`` and ``loader.DistScanTrainer``: the epoch body;
- ``loader.RunTrainer``: the run body (its epoch-end early-stop read is
  the run's bookkeeping and sits outside, as the overflow fetch does);
- ``storage.TieredScanTrainer``: the epoch body, the prologue's one
  fetch of the plan's node ids let through (:func:`explicit`);
- ``serving.EmbeddingMaterializer``: each pass's store init and chunks;
- ``distributed.RemoteScanTrainer``: the epoch body.

Where the two guards differ:

- JAX's transfer guard forbids IMPLICIT transfers and lets explicit
  ``device_put`` / ``device_get`` through; the card's sync debug mode
  flags every sync. The port's deliberate transfers inside a region
  (the tiered prologue's plan fetch, the seed pool's first upload, a
  CUDA graph capture, which synchronizes the card on entry) run under
  :func:`explicit`, the counterpart of an explicit ``device_get``.
- JAX's guard is thread-local; the sync debug mode is process-wide. A
  thread that syncs while another holds a region (a stager worker, a
  ``DistServer`` handler in the same process) raises too: the port's
  stagers make no sync (pinned slots, events queried, never waited on
  inside a region), and a same-process server is not run beside a
  guarded epoch.
- ``jax.checking_leaks`` has no torch counterpart (no tracer can
  escape an eager or captured step): not ported.

Off the card (or without ``GLT_STRICT``) both contexts are no-ops: one
env check at entry.
"""
import contextlib
import gc
import os

import torch

ENV_VAR = 'GLT_STRICT'


def strict_enabled() -> bool:
  """True when GLT_STRICT is set to anything but '' / '0'."""
  return os.environ.get(ENV_VAR, '') not in ('', '0')


def _sync_api():
  """``(get, set)`` of the card's sync debug mode, or None without a
  card (a CPU build of torch cannot set it)."""
  if not torch.cuda.is_available():
    return None
  return torch.cuda.get_sync_debug_mode, torch.cuda.set_sync_debug_mode


@contextlib.contextmanager
def _sync_mode(mode):
  api = _sync_api()
  if api is None:
    yield
    return
  get, set_ = api
  prev = get()
  set_(mode)
  try:
    yield
  finally:
    set_(prev)


@contextlib.contextmanager
def strict_guards():
  """``set_sync_debug_mode('error')`` when GLT_STRICT is on, the previous
  mode restored on exit; a no-op otherwise. Reads the env var per call
  so tests can toggle it with monkeypatch.setenv."""
  if not strict_enabled():
    yield
    return
  if _sync_api() is not None:
    # garbage that holds a CUDA graph goes first: releasing a graph's
    # memory pool synchronizes, and the collector may run in the region
    gc.collect()
  with _sync_mode('error'):
    yield


@contextlib.contextmanager
def explicit():
  """A deliberate host sync inside a strict region (the counterpart of
  JAX's explicit ``device_get``, which its transfer guard lets through):
  the sync debug mode is off inside, restored after. A no-op without
  GLT_STRICT."""
  if not strict_enabled():
    yield
    return
  with _sync_mode(0):
    yield
