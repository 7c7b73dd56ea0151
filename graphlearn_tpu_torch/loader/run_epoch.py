"""The training run as one stream of chunks: ``RunTrainer``.

Counterpart of ``graphlearn_tpu/loader/run_epoch.py:RunTrainer``, with
its contract:

- The prologue draws all E epochs' seed matrices, epoch ``e`` under
  ``fold_in(perm_key, epoch0 + e)`` (the key ``ScanTrainer`` folds for
  that epoch), into one ``[E * steps, B]`` matrix, and the chunks run
  over that flat step stream, crossing epoch boundaries.
- Each step also counts, on the device, the correct and total seed slots
  of the batch under the parameters before its update (one forward,
  ``models.train.make_eval_counts``); at each epoch's last step the
  counts become the epoch's metric, and with ``patience`` an epoch that
  fails to improve ``best + min_delta`` counts towards the early stop.
  With the stop never set, losses and parameters are those of E
  ``ScanTrainer`` epochs bit for bit.
- ``last_run_report`` holds device tensors: ``eval_metric`` ``[E]``
  (NaN for epochs never reached), ``best_metric``, ``epochs_run`` and
  ``stopped``.
- The run's overflow flag gathers over all epochs and the loader's
  policy fires once, at the run's end.

The eval carry (``correct``, ``total``, ``best``, ``bad``, ``stop``,
``edone``, ``metrics``) lives in device tensors that the steps update in
place, so one captured graph per chunk length serves every chunk of the
run: a step reads its global index ``g`` from a static counter
(``gstart`` plus its place in the chunk) and derives ``g``'s epoch and
whether it ends one on the device. No Python int of the run's position
is frozen into a graph.

Early stop. JAX runs each step under ``lax.cond(stop, no-op, step)``:
a stopped step does no device work. Here a stopped step is masked: with
``patience`` set, each step keeps a copy of the parameters and Adam's
tensors, runs, and puts the old values back under ``torch.where(stop,
old, new)`` (the eval carry too); its loss and accuracy are 0 and the
overflow flag is left as it was. Every value equals JAX's no-op branch,
with no host round trip, but stopped steps still spend device time
(CUDA's conditional graph nodes are the lever for that). The sampler's
counter still advances by the scheduled steps, and ``TrainState.step``
counts them too (Adam's own step tensor counts the updates made).

``stage_hook`` / ``ack_hook`` and the recovery protocol are
``ScanTrainer``'s; a snapshot adds the eval carry as ``eval:*`` arrays, so
``recovery.ChunkCheckpointer`` attaches unchanged and a crash resumes at
the last chunk boundary of the right epoch. Padded-window sampling is
refused, as in JAX: its table is reseeded between epochs, and a run's
chunks cross epoch boundaries (run a ``ScanTrainer`` per epoch there).

Usage::

    trainer = RunTrainer(loader, model, num_classes, chunk_size=32,
                         epochs=20, patience=3)
    state, losses, accs = trainer.run(state)
    report = trainer.last_run_report   # device tensors: read once
"""
from typing import Optional

import numpy as np
import torch

from .. import metrics, ops
from .. import random as trandom
from ..metrics import spans
from ..models import train as train_lib
from .node_loader import NodeLoader
from .scan_epoch import ScanTrainer


def _upload(arr, device) -> torch.Tensor:
  """A host array on ``device`` without a host sync (pinned, non-blocking
  on a card)."""
  t = torch.from_numpy(np.array(arr))   # a contiguous copy, 0-d kept
  if device.type == 'cuda':
    return t.pin_memory().to(device, non_blocking=True)
  return t


class RunTrainer(ScanTrainer):
  """Runs E epochs as ``ceil(E * steps / chunk_size)`` chunks.

  Args (beyond ``ScanTrainer``'s):
    epochs: E, the epochs of the run.
    patience: stop after this many consecutive epochs whose eval metric
      failed to improve ``best + min_delta`` (None: never stop, the
      bit-identity contract's mode).
    min_delta: the least improvement that resets the patience count.
    track_eval: count the eval metric (one more forward per step, a pure
      read). ``False`` leaves ``eval_metric`` NaN; ``patience`` needs
      True.

  ``config=`` (a tune artifact) is ``ScanTrainer``'s; a padded-window
  loader is refused either way, so an artifact ``tune()`` signed never
  carries a padded window. ``GLT_STRICT``'s region is ``ScanTrainer``'s
  epoch body, here the whole run's.
  """

  _NAME = 'RunTrainer'
  _SITES = ('run_epoch_seeds', 'run_scan_chunk', 'run_metrics_concat')

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               chunk_size: Optional[int] = None, epochs: int = 1,
               patience: Optional[int] = None, min_delta: float = 0.0,
               seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None, config=None,
               track_eval: bool = True, capture: Optional[bool] = None):
    super().__init__(loader, model, num_classes, chunk_size=chunk_size,
                     seed_labels_only=seed_labels_only, perm_seed=perm_seed,
                     config=config, capture=capture)
    if epochs < 1:
      raise ValueError(f'epochs must be >= 1, got {epochs}')
    if patience is not None and patience < 1:
      raise ValueError(f'patience must be >= 1 or None, got {patience}')
    if patience is not None and not track_eval:
      raise ValueError('patience requires track_eval=True: the early-stop '
                       'flag is a function of the eval metric')
    if getattr(self._sampler, 'padded_window', None) is not None:
      raise ValueError(
          f'{self._NAME} cannot fold padded-window sampling into one run: '
          'the padded table is reseeded between epochs '
          '(NodeLoader._begin_epoch) and a run\'s chunks cross epoch '
          'boundaries. Run a ScanTrainer per epoch there, or drop '
          'padded_window')
    self.epochs = int(epochs)
    self.patience = None if patience is None else int(patience)
    self.min_delta = float(min_delta)
    self.track_eval = bool(track_eval)
    self._eval_counts = (train_lib.make_eval_counts(model)
                         if self.track_eval else None)
    self.last_run_report = None
    self._resume_eval = None   # recovery: the eval carry at the boundary
    self._ev = None            # the eval carry, updated in place
    self._steps_per_epoch = None

  @property
  def _epochs_per_run(self) -> int:
    return self.epochs

  def _epoch_steps(self) -> int:
    # the run is the unit: start_step, max_steps and the hooks' steps
    # count over E * steps
    return len(self.loader._batcher) * self.epochs

  def run(self, state, max_steps: Optional[int] = None,
          start_step: int = 0, resume_overflow: bool = False):
    """The whole run (``run_epoch`` under the name the checkpointer
    calls). Returns ``(state, losses, accs)``, ``[E * steps]`` device
    tensors; after an early stop the stopped tail is zeros."""
    return self.run_epoch(state, max_steps=max_steps, start_step=start_step,
                          resume_overflow=resume_overflow)

  def run_epoch(self, state, max_steps: Optional[int] = None,
                start_step: int = 0, resume_overflow: bool = False):
    metrics.inc('run.runs')
    metrics.inc('run.epochs_scheduled', self.epochs)
    # a zero-step run returns before the body sets a report
    self.last_run_report = None
    # the run's span: the inherited epoch.run / epoch.chunk spans parent
    # under it
    with spans.span('run.train', emitter=self._NAME, epochs=self.epochs,
                    epoch0=self._epochs):
      return super().run_epoch(state, max_steps=max_steps,
                               start_step=start_step,
                               resume_overflow=resume_overflow)

  def _prologue(self, full_steps: int):
    steps = full_steps // self.epochs
    mats, masks = zip(*(
        self._epoch_seeds(trandom.fold_in(self._perm_key, self._epochs + e),
                          steps) for e in range(self.epochs)))
    return torch.cat(mats), torch.cat(masks)

  def _begin_run(self, full_steps: int):
    """Set the eval carry to a run's start (or to the resumed boundary's)
    in place, on the run's stream."""
    self._steps_per_epoch = full_steps // self.epochs
    device = self.loader.device
    if self._ev is None:
      dtypes = dict(correct=torch.int32, total=torch.int32,
                    best=torch.float32, bad=torch.int32, stop=torch.bool,
                    edone=torch.int32, metrics=torch.float32)
      self._ev = {k: torch.zeros((self.epochs,) if k == 'metrics' else (),
                                 dtype=dt, device=device)
                  for k, dt in dtypes.items()}
    ev = self._ev
    if self._resume_eval is not None:
      for key, val in self._resume_eval.items():
        ev[key].copy_(_upload(val, device))
      self._resume_eval = None
      return
    for key in ('correct', 'total', 'bad', 'stop', 'edone'):
      ev[key].zero_()
    ev['best'].fill_(float('-inf'))
    ev['metrics'].fill_(float('nan'))

  def _end_run(self):
    ev = self._ev
    self.last_run_report = dict(eval_metric=ev['metrics'].clone(),
                                best_metric=ev['best'].clone(),
                                epochs_run=ev['edone'].clone(),
                                stopped=ev['stop'].clone())

  def _carry(self, **carry) -> dict:
    return dict(carry, eval=self._ev)

  def _chunk_args(self, seed_mat, mask_mat, base_key, count: int,
                  start: int, k: int) -> dict:
    args = super()._chunk_args(seed_mat, mask_mat, base_key, count, start, k)
    args['gstart'] = torch.full((), start, dtype=torch.int64,
                                device=seed_mat.device)
    return args

  def _chunk(self, state, seeds, masks, base_key, counter, gstart):
    """``ScanTrainer``'s chunk with the eval carry: step ``j`` is the
    run's step ``gstart + j``."""
    k = seeds.shape[0]
    keys = ops.step_keys(base_key, counter, k, self._n_hops)
    ovf = torch.zeros((), dtype=torch.bool, device=seeds.device)
    losses, accs = [], []
    for j in range(k):
      batch, overflow = self._sample_collate(seeds[j], masks[j], keys[j])
      loss, acc, overflow = self._run_step(state, batch, overflow,
                                           gstart + j)
      ovf = ovf | overflow
      losses.append(loss)
      accs.append(acc)
    return torch.stack(losses), torch.stack(accs), ovf, keys

  def _run_step(self, state, batch, overflow, g):
    """One step of the run: the eval counts of the parameters before the
    update, the train step and the eval carry's update; with
    ``patience``, masked by the stop flag read at the step's entry."""
    ev = self._ev
    masked = self.patience is not None
    if masked:
      stop = ev['stop'].clone()
      saved = _save(self._updated_tensors(state))
    is_end = (g + 1) % self._steps_per_epoch == 0
    if self.track_eval:
      correct, total = self._eval_counts(batch)
    _, loss, acc = self._train_step(state, batch)
    if self.track_eval:
      new = self._eval_update(ev, correct, total, is_end, g)
    else:
      new = dict(edone=ev['edone'] + is_end.to(torch.int32))
    if masked:
      _restore(stop, saved)
      new = {key: torch.where(stop, ev[key], val)
             for key, val in new.items()}
      loss = torch.where(stop, 0.0, loss)
      acc = torch.where(stop, 0.0, acc)
      overflow = overflow & ~stop
    for key, val in new.items():
      ev[key].copy_(val)
    return loss, acc, overflow

  def _eval_update(self, ev, correct, total, is_end, g) -> dict:
    """The eval carry after a step (JAX's ``active`` branch)."""
    correct = ev['correct'] + correct.to(torch.int32)
    total = ev['total'] + total.to(torch.int32)
    metric = correct.float() / torch.clamp(total, min=1).float()
    improved = metric > ev['best'] + self.min_delta
    best = torch.where(is_end & improved, metric, ev['best'])
    bad = torch.where(is_end, torch.where(improved, 0, ev['bad'] + 1),
                      ev['bad'])
    stop = ev['stop']
    if self.patience is not None:
      stop = stop | (is_end & (bad >= self.patience))
    epoch = torch.clamp(g // self._steps_per_epoch, max=self.epochs - 1)
    metrics = torch.where(
        is_end, ev['metrics'].scatter(0, epoch.reshape(1), metric.reshape(1)),
        ev['metrics'])
    return dict(correct=torch.where(is_end, 0, correct),
                total=torch.where(is_end, 0, total), best=best, bad=bad,
                stop=stop, edone=ev['edone'] + is_end.to(torch.int32),
                metrics=metrics)

  def _updated_tensors(self, state) -> list:
    """What a train step updates in place: the parameters and the
    optimizer's state tensors (empty before its first step)."""
    params = list(self.model.parameters())
    return params + [v for p in params
                     for v in state.optimizer.state.get(p, {}).values()
                     if torch.is_tensor(v)]

  def _flight_config(self) -> dict:
    cfg = super()._flight_config()
    cfg.update(epochs=self.epochs, patience=self.patience,
               min_delta=self.min_delta, track_eval=self.track_eval)
    return cfg

  # ------------------------------------------------- recovery protocol

  def _recovery_capture(self, carry):
    meta, dev = super()._recovery_capture(carry)
    meta['epochs_total'] = self.epochs
    for key, val in carry['eval'].items():
      dev[f'eval:{key}'] = val
    return meta, dev

  def _recovery_load(self, meta, arrays):
    ev = {k[len('eval:'):]: np.asarray(v) for k, v in (arrays or {}).items()
          if k.startswith('eval:')}
    super()._recovery_load(meta, {})
    self._resume_eval = ev or None


def _save(tensors) -> list:
  """One flat copy per device and dtype: ``[(tensors, copy)]``."""
  groups = {}
  for t in tensors:
    groups.setdefault((t.device, t.dtype), []).append(t)
  return [(ts, torch.cat([t.detach().reshape(-1) for t in ts]))
          for ts in groups.values()]


@torch.no_grad()
def _restore(stop, saved):
  """``t = where(stop, saved, t)`` in place for every saved tensor."""
  for ts, old in saved:
    new = torch.cat([t.reshape(-1) for t in ts])
    sel = torch.where(stop, old, new).split([t.numel() for t in ts])
    torch._foreach_copy_(ts, [s.view_as(t) for s, t in zip(sel, ts)])
