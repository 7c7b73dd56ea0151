"""ChunkCheckpointer: asynchronous exact checkpoints at chunk boundaries,
and the mid-epoch resume that replays the rest of the epoch.

Counterpart of ``graphlearn_tpu/recovery/checkpoint.py``. Every draw of a
``ScanTrainer`` / ``RunTrainer`` / ``DistScanTrainer`` epoch is addressed
by a counter, so a snapshot at a chunk boundary needs only the train
state, the losses so far and a few counters: :meth:`ChunkCheckpointer.resume_epoch` replays
the remaining chunks from them, bit-identically where the device sums in
a fixed order (the CPU) and within the card's atomics elsewhere.

Mechanics:

* :meth:`attach` chains onto the trainer's ``ack_hook``. At a cadence
  boundary the dispatch thread enqueues, on the trainer's stream, one
  device copy per dtype of the boundary state (parameters, Adam's
  tensors, the losses and accuracies so far, the overflow flag, the
  trainer's extras) into a staging buffer, and on a copy stream a
  non-blocking copy of it into pinned host memory and an event. The
  dispatch thread never waits for the device: the next chunk runs on
  while the copy is in flight, and a writer thread waits for the event
  (polling it) before it serializes. JAX instead fetches with one
  ``jax.device_get``, which its buffer donation makes safe; here the
  next replay would overwrite the live tensors, hence the staging copy.
* The bounded writer thread writes the snapshot atomically
  (``recovery/snapshot.py``). A full queue or a failed writer degrades
  to a synchronous write on the dispatch thread
  (``checkpoint.sync_fallback``), which waits for the copy; a failing
  save never ends the epoch (``checkpoint.save_errors``). Torn files are
  skipped on restore (``checkpoint.torn_skipped``).
* :meth:`resume_epoch` restores the newest valid snapshot into a fresh
  trainer (after a config-fingerprint check) through
  ``model.load_state_dict`` and ``optimizer.load_state_dict``, rewinds
  the sampler and epoch counters and runs
  ``run_epoch(start_step=...)`` over the remaining chunks.

A snapshot holds each parameter by its ``named_parameters()`` name
(``param:<name>``), each Adam state tensor by parameter name and key
(``adam:<name>:<key>``: ``exp_avg``, ``exp_avg_sq``, ``step``),
``losses`` / ``accs`` (the whole epoch so far) and ``extra:<name>``
arrays; the meta holds ``TrainState.step``, the groups' learning rates,
the overflow flag, the epoch position and the sampler's ``state_dict()``.
The metrics go through ``graphlearn_tpu_torch.metrics`` under JAX's
names, and each snapshot write is a ``checkpoint.save`` span and each
resume a ``recovery.resume`` span (the resumed epoch's ``epoch.run``
under it). A snapshot write and a restore pass JAX's ``recovery.save``
and ``recovery.restore`` fault sites (``recovery.snapshot``).
"""
import hashlib
import json
import logging
import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import metrics
from ..metrics import spans
from . import snapshot as snapshot_lib
from .snapshot import Snapshot, TornSnapshotError

logger = logging.getLogger('graphlearn_tpu_torch.recovery')

# pinned staging buffers are kept in sizes of whole 64 Ki-element blocks,
# so a boundary whose losses grew by a chunk reuses the previous buffer
_PIN_BLOCK = 1 << 16
_POLL_S = 2e-4   # the writer's wait between two queries of a copy's event


def _jsonable(obj):
  """Best-effort JSON coercion (the copy of
  ``graphlearn_tpu/metrics/flight.py:_jsonable``)."""
  if isinstance(obj, dict):
    return {str(k): _jsonable(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_jsonable(v) for v in obj]
  if isinstance(obj, (str, int, float, bool)) or obj is None:
    return obj
  return str(obj)


def config_fingerprint(config: dict) -> str:
  """Stable 16-hex digest of a trainer's configuration (the copy of
  ``graphlearn_tpu/metrics/flight.py:config_fingerprint``): the same
  config gives the same digest in both packages."""
  blob = json.dumps(_jsonable(config or {}), sort_keys=True)
  return hashlib.sha1(blob.encode()).hexdigest()[:16]


class _AckChain:
  """The installed ack_hook: any hook installed before, then the
  checkpointer's boundary capture."""

  __slots__ = ('ckpt', 'prev')

  def __init__(self, ckpt, prev):
    self.ckpt = ckpt
    self.prev = prev

  def __call__(self, c, start, k):
    if self.prev is not None:
      self.prev(c, start, k)
    self.ckpt._on_ack(c, start, k)


class _Staging:
  """Copies named tensors to the host without a host sync: per device
  and dtype one ``torch.cat`` on the current stream (the staging copy),
  then on a copy stream one non-blocking copy into pinned memory and an
  event. CPU tensors are copied at once."""

  def __init__(self):
    self._streams = {}
    self._pinned: Dict[tuple, list] = {}   # (dtype, numel) -> free buffers
    self._lock = threading.Lock()

  def _take(self, dtype, n: int) -> torch.Tensor:
    cap = -(-max(n, 1) // _PIN_BLOCK) * _PIN_BLOCK
    with self._lock:
      free = self._pinned.get((dtype, cap))
      if free:
        return free.pop()
    return torch.empty(cap, dtype=dtype, pin_memory=True)

  def _give(self, buf: torch.Tensor):
    with self._lock:
      self._pinned.setdefault((buf.dtype, buf.numel()), []).append(buf)

  def start(self, tensors: Dict[str, torch.Tensor]) -> '_HostCopy':
    host, groups = {}, {}
    for name, t in tensors.items():
      t = t.detach()
      if t.device.type == 'cuda':
        groups.setdefault((t.device, t.dtype), []).append((name, t))
      else:
        host[name] = t.clone().numpy()
    pending = []
    for (dev, dtype), items in groups.items():
      flat = torch.cat([t.reshape(-1) for _, t in items])
      stream = self._streams.get(dev)
      if stream is None:
        stream = self._streams[dev] = torch.cuda.Stream(dev)
      stream.wait_stream(torch.cuda.current_stream(dev))
      pinned = self._take(dtype, flat.numel())
      with torch.cuda.stream(stream):
        pinned[:flat.numel()].copy_(flat, non_blocking=True)
        flat.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
      layout, off = [], 0
      for name, t in items:
        layout.append((name, tuple(t.shape), off, t.numel()))
        off += t.numel()
      pending.append((layout, pinned, done))
    return _HostCopy(self, host, pending)


class _HostCopy:
  """Named host arrays on their way from the device; :meth:`result`
  waits for the copies (querying their events) once."""

  def __init__(self, staging, host, pending):
    self._staging = staging
    self._host = host
    self._pending = pending
    self._lock = threading.Lock()

  def result(self) -> Dict[str, np.ndarray]:
    with self._lock:
      for layout, pinned, done in self._pending:
        while not done.query():
          time.sleep(_POLL_S)
        flat = pinned.numpy()
        for name, shape, off, n in layout:
          self._host[name] = flat[off:off + n].reshape(shape).copy()
        self._staging._give(pinned)
      self._pending = []
      return self._host


class _Boundary:
  """One captured boundary: its meta (the overflow flag still on its way)
  and the copy of its tensors. :meth:`resolve` gives ``(meta, arrays)``
  in the file's layout."""

  def __init__(self, meta, copy, prefix):
    self.meta = meta
    self._copy = copy
    self._prefix = prefix

  def resolve(self):
    arrays = dict(self._copy.result())
    meta = dict(self.meta, overflow=bool(arrays.pop('ovf')))
    for key in ('losses', 'accs'):
      arrays[key] = np.asarray(arrays[key], np.float32)
      if self._prefix is not None:
        arrays[key] = np.concatenate([self._prefix[key], arrays[key]])
    return meta, arrays


class ChunkCheckpointer:
  """Chunk-cadence exact checkpointing for ``ScanTrainer`` and
  ``RunTrainer``.

  Args:
    directory: snapshot directory, or None for memory-only snapshots.
    every: disk cadence in chunks (a snapshot lands after chunks
      ``every-1``, ``2*every-1``, ... and after the final chunk). A
      resume replays at most ``every`` chunks.
    keep: newest snapshots kept on disk (older ones pruned after each
      write; >= 2 keeps a fallback for a torn file).
    mem_every: memory snapshot cadence (None: the disk cadence).
    max_pending: bounded writer queue depth; a boundary that finds it
      full writes synchronously.

  Usage::

      ckpt = ChunkCheckpointer('ckpts/run1', every=4).attach(trainer)
      state, losses, accs = trainer.run_epoch(state)   # checkpointed
      # after a crash, in a fresh process:
      ckpt = ChunkCheckpointer('ckpts/run1').attach(fresh_trainer)
      state, losses, accs = ckpt.resume_epoch(fresh_trainer, template)
  """

  def __init__(self, directory: Optional[str] = None, every: int = 4,
               keep: int = 2, mem_every: Optional[int] = None,
               max_pending: int = 2):
    if every < 1:
      raise ValueError(f'every must be >= 1, got {every}')
    if keep < 1:
      raise ValueError(f'keep must be >= 1, got {keep}')
    self.directory = directory
    self.every = int(every)
    self.keep = int(keep)
    self.mem_every = int(mem_every) if mem_every is not None else None
    self.max_pending = int(max_pending)
    self.degraded = False    # a writer-thread save failed this run
    self._latest_mem: Optional[_Boundary] = None
    self._trainer = None
    self._prev_ack = None
    self._staging = _Staging()
    self._q: 'queue.Queue' = queue.Queue(maxsize=max(1, max_pending))
    self._worker: Optional[threading.Thread] = None
    self._wlock = threading.Lock()   # serializes file writes and prunes
    self._stop = False

  # ----------------------------------------------------------- lifecycle

  def attach(self, trainer) -> 'ChunkCheckpointer':
    """Chain this checkpointer onto ``trainer``'s ``ack_hook``. Returns
    self."""
    if self._trainer is not None:
      raise RuntimeError('already attached; detach() first')
    self._trainer = trainer
    self._prev_ack = trainer.ack_hook
    trainer.ack_hook = _AckChain(self, self._prev_ack)
    return self

  def detach(self):
    """Restore the trainer's previous ack_hook."""
    if self._trainer is not None:
      self._trainer.ack_hook = self._prev_ack
      self._trainer = None
      self._prev_ack = None

  def flush(self):
    """Block until every queued write has reached the disk."""
    self._q.join()

  def close(self):
    """Drain the pending writes and stop the writer thread."""
    self.flush()
    self._stop = True
    self._q.put(None)
    w = self._worker
    if w is not None:
      w.join(timeout=10.0)
    self._worker = None
    self._stop = False
    try:     # drain a leftover sentinel
      while True:
        self._q.get_nowait()
        self._q.task_done()
    except queue.Empty:
      pass

  @property
  def latest_mem(self) -> Optional[Snapshot]:
    """The newest memory snapshot (waits for its copy), or None."""
    b = self._latest_mem
    return None if b is None else Snapshot(*b.resolve())

  def _ensure_worker(self):
    if self._worker is not None and self._worker.is_alive():
      return
    self._worker = threading.Thread(target=self._loop, daemon=True,
                                    name='glt-torch-chunk-checkpointer')
    self._worker.start()

  def _loop(self):
    while True:
      item = self._q.get()
      try:
        if item is None or self._stop:
          return
        self._write_item(item, sync=False)
      finally:
        self._q.task_done()

  # ------------------------------------------------------------- capture

  def _on_ack(self, c: int, start: int, k: int):
    """Chunk boundary: decide the cadence, start the host copy and route
    it to memory and/or the writer. Never raises: a checkpoint failure
    must not end the epoch it protects."""
    try:
      trainer = self._trainer
      carry = getattr(trainer, '_chunk_carry', None)
      if carry is None:
        return
      next_start = start + k
      final = next_start >= int(carry['steps'])
      disk_hit = self.directory is not None and (
          (c + 1) % self.every == 0 or final)
      mem_hit = (c + 1) % (self.mem_every or self.every) == 0 or final
      if not (disk_hit or mem_hit):
        return
      t0 = time.perf_counter()
      boundary = self._capture(trainer, carry, c, next_start)
      if boundary is None:
        return
      metrics.observe('checkpoint.capture_ms',
                      (time.perf_counter() - t0) * 1e3)
      if mem_hit:
        self._latest_mem = boundary
      if disk_hit:
        self._submit(boundary)
    except Exception:
      metrics.inc('checkpoint.save_errors')
      logger.exception('chunk checkpoint capture failed: the epoch goes '
                       'on unprotected past this boundary')

  def _capture(self, trainer, carry: dict, c: int,
               next_start: int) -> Optional[_Boundary]:
    """Start the host copy of the boundary state (no host sync). None
    where the boundary cannot give a whole-epoch snapshot: a resumed
    epoch whose loss prefix is unknown."""
    start_step = int(carry.get('start_step', 0))
    prefix = None
    if start_step:
      # a resumed epoch produces losses only for [start_step, now):
      # resume_epoch leaves the checkpointed prefix on the trainer so a
      # snapshot taken during the replay still covers the whole epoch
      prefix = getattr(trainer, '_recovery_prefix', None)
      if (prefix is None or prefix['epoch'] != int(trainer._epochs)
          or prefix['start_step'] != start_step):
        logger.warning(
            'chunk %d boundary of a start_step=%d epoch has no loss '
            'prefix (run_epoch(start_step=...) called outside '
            'resume_epoch?): skipping this snapshot rather than writing a '
            'partial-loss one', c, start_step)
        return None
    meta_extra, dev_extra = trainer._recovery_capture(carry)
    state = carry['state']
    opt = state.optimizer
    tensors, names = {}, []
    for name, p in trainer.model.named_parameters():
      names.append(name)
      tensors[f'param:{name}'] = p
      for key, v in opt.state.get(p, {}).items():
        tensors[f'adam:{name}:{key}'] = torch.as_tensor(v)
    losses, accs = carry['losses'], carry['accs']
    device = carry['ovf'].device
    tensors['losses'] = (torch.cat(losses) if losses else
                         torch.zeros(0, dtype=torch.float32, device=device))
    tensors['accs'] = (torch.cat(accs) if accs else
                       torch.zeros(0, dtype=torch.float32, device=device))
    tensors['ovf'] = carry['ovf']
    for key, t in dev_extra.items():
      tensors[f'extra:{key}'] = t
    meta = dict(format=1, trainer=trainer._NAME,
                epoch=int(trainer._epochs), chunk=int(c),
                next_start=int(next_start), steps=int(carry['steps']),
                full_steps=int(carry['full_steps']),
                chunk_size=int(trainer.chunk_size),
                train_step=int(state.step),
                lrs=[float(g['lr']) for g in opt.param_groups], params=names,
                config_fingerprint=config_fingerprint(
                    trainer._recovery_config()))
    meta.update(meta_extra)
    return _Boundary(meta, self._staging.start(tensors), prefix)

  # --------------------------------------------------------------- write

  def _submit(self, boundary: _Boundary):
    self._ensure_worker()
    if self.degraded or self._worker is None or \
        not self._worker.is_alive():
      metrics.inc('checkpoint.sync_fallback')
      self._write_item(boundary, sync=True)
      return
    try:
      self._q.put_nowait(boundary)
    except queue.Full:
      # a slow writer: never stall the epoch unbounded, write inline
      metrics.inc('checkpoint.sync_fallback')
      self._write_item(boundary, sync=True)

  def _write_item(self, boundary: _Boundary, sync: bool):
    meta = boundary.meta
    try:
      meta, arrays = boundary.resolve()
      with self._wlock:
        with spans.span('checkpoint.save', epoch=meta['epoch'],
                        next_start=meta['next_start'], sync=sync):
          t0 = time.perf_counter()
          _, nbytes = snapshot_lib.write_snapshot(self.directory, meta,
                                                  arrays)
          metrics.observe('checkpoint.save_ms',
                          (time.perf_counter() - t0) * 1e3)
          metrics.inc('checkpoint.saves')
          metrics.inc('checkpoint.bytes', nbytes)
        self._prune()
    except Exception as e:
      # a failed save degrades (later boundaries write inline) but never
      # propagates: the epoch it protects must finish
      self.degraded = True
      metrics.inc('checkpoint.save_errors')
      logger.warning('checkpoint save at epoch %s step %s failed (%s): '
                     'degrading to synchronous writes (sync=%s)',
                     meta.get('epoch'), meta.get('next_start'), e, sync)

  def _prune(self):
    for _, _, path in snapshot_lib.list_snapshots(
        self.directory)[:-self.keep]:
      try:
        os.unlink(path)
      except OSError:
        pass

  # -------------------------------------------------------------- resume

  def latest(self) -> Optional[Snapshot]:
    """The newest valid snapshot on disk (torn or unreadable files are
    skipped and counted in ``checkpoint.torn_skipped``), or None."""
    if self.directory is None:
      return None
    t0 = time.perf_counter()
    for _, _, path in reversed(snapshot_lib.list_snapshots(
        self.directory)):
      try:
        snap = snapshot_lib.load_snapshot(path)
        metrics.observe('checkpoint.restore_ms',
                        (time.perf_counter() - t0) * 1e3)
        return snap
      except (TornSnapshotError, OSError, ValueError) as e:
        metrics.inc('checkpoint.torn_skipped')
        logger.warning('skipping unrestorable snapshot %s: %s', path, e)
      except Exception as e:  # noqa: BLE001 - injected restore faults land here
        metrics.inc('checkpoint.torn_skipped')
        logger.warning('snapshot %s failed to restore (%s) — falling '
                       'back to the previous one', path, e)
    return None

  def resume_epoch(self, trainer, state_template,
                   snapshot: Optional[Snapshot] = None):
    """Restore the newest snapshot (or ``snapshot``) into ``trainer``
    and finish its epoch. Returns ``(state, losses, accs)`` with losses
    and accs host float32 arrays covering the whole epoch (the
    checkpointed prefix and the replayed rest).

    ``trainer`` is typically a fresh one over an identically configured
    loader; the snapshot's config fingerprint is checked against it.
    ``state_template`` is a ``TrainState`` whose optimizer holds the
    trainer's model's parameters (a fresh ``create_train_state``): the
    snapshot's parameters and Adam tensors are loaded into the model and
    that optimizer by ``load_state_dict``, its rates into the optimizer's
    groups, and ``TrainState.step`` into the returned state.
    """
    if self._trainer is not None and self._trainer is not trainer:
      raise RuntimeError('attached to a different trainer; detach() or '
                         'attach to the one being resumed')
    if self._worker is not None:
      self.flush()
    snap = snapshot or self.latest()
    if snap is None:
      raise FileNotFoundError(
          f'no restorable snapshot in {self.directory!r}')
    meta = snap.meta
    if meta.get('trainer') != trainer._NAME:
      raise ValueError(
          f"snapshot was written by {meta.get('trainer')!r}, resuming "
          f'into {trainer._NAME!r} would diverge')
    fp = config_fingerprint(trainer._recovery_config())
    if meta.get('config_fingerprint') != fp:
      raise ValueError(
          f"snapshot config fingerprint {meta.get('config_fingerprint')} "
          f"!= this trainer's {fp}: the loader, trainer or sampler "
          'configuration drifted (batch, chunk size, fanouts, shuffle, '
          'sampling, or the seed pool itself); resuming would not replay '
          'the same stream')
    state = _load_train_state(trainer.model, state_template, snap)
    extras = {k[len('extra:'):]: v for k, v in snap.arrays.items()
              if k.startswith('extra:')}
    steps, next_start = int(meta['steps']), int(meta['next_start'])
    saved_losses = np.asarray(snap.arrays['losses'])
    saved_accs = np.asarray(snap.arrays['accs'])
    metrics.inc('recovery.resumes')
    if next_start >= steps:
      # the epoch finished before the crash: the counters go past it and
      # its final state is handed back; the caller starts the next epoch
      trainer._recovery_advance(meta)
      return state, saved_losses, saved_accs
    trainer._recovery_load(meta, extras)
    k = int(meta['chunk_size'])
    replay_chunks = -(-(steps - next_start) // k)
    metrics.inc('recovery.resume_chunks', replay_chunks)
    max_steps = steps if steps < int(meta['full_steps']) else None
    trainer._recovery_prefix = dict(epoch=int(meta['epoch']),
                                    start_step=next_start,
                                    losses=saved_losses, accs=saved_accs)
    try:
      with spans.span('recovery.resume', epoch=meta['epoch'],
                      start_step=next_start, replay_chunks=replay_chunks):
        state, losses, accs = trainer.run_epoch(
            state, max_steps=max_steps, start_step=next_start,
            resume_overflow=bool(meta.get('overflow', False)))
    finally:
      trainer._recovery_prefix = None
    return (state,
            np.concatenate([saved_losses, losses.detach().cpu().numpy()]),
            np.concatenate([saved_accs, accs.detach().cpu().numpy()]))


def _load_train_state(model, template, snap: Snapshot):
  """Load a snapshot's parameters into ``model`` and its Adam state and
  rates into ``template.optimizer``, both by ``load_state_dict``; returns
  the template with the snapshot's ``TrainState.step``."""
  meta, arrays = snap.meta, snap.arrays
  named = list(model.named_parameters())
  names = [n for n, _ in named]
  if names != list(meta['params']):
    raise ValueError(f'the model\'s parameters {names} are not the '
                     f"snapshot's {meta['params']}")
  model.load_state_dict(
      {n: torch.from_numpy(arrays[f'param:{n}']) for n in names},
      strict=False)
  opt = template.optimizer
  name_of = {id(p): n for n, p in named}
  sd = opt.state_dict()
  state = {}
  for g, sg in zip(opt.param_groups, sd['param_groups']):
    for p, i in zip(g['params'], sg['params']):
      name = name_of.get(id(p))
      if name is None:
        raise ValueError('the optimizer holds a parameter the model does '
                         'not name')
      pre = f'adam:{name}:'
      st = {k[len(pre):]: torch.from_numpy(v) for k, v in arrays.items()
            if k.startswith(pre)}
      if st:
        state[i] = st
  lrs = meta['lrs']
  if len(lrs) != len(sd['param_groups']):
    raise ValueError(f'the optimizer has {len(sd["param_groups"])} groups, '
                     f'the snapshot {len(lrs)}')
  for sg, lr in zip(sd['param_groups'], lrs):
    sg['lr'] = float(lr)
  opt.load_state_dict({'state': state, 'param_groups': sd['param_groups']})
  return template._replace(step=int(meta['train_step']))
