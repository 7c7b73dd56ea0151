"""Chunk-granular failover for the scanned distributed epoch.

Counterpart of ``graphlearn_tpu/recovery/failover.py``. A
``DistScanTrainer`` runs a K-step chunk as one unit (one CUDA graph
replay on a card), so there is no per-batch point to acknowledge from:
the unit of loss on a shard death is at most one chunk.

:class:`FailoverRunner` drives one distributed epoch with:

* **liveness**: any object with ``dead_ranks() -> {rank: cause}``,
  polled at every chunk boundary (the trainer's ``stage_hook``); a dead
  rank raises :class:`ShardDeadError` before the next chunk is enqueued.
* **a rollback buffer**: a memory-only ``ChunkCheckpointer(None,
  every=1, mem_every=1)`` snapshots every boundary, so the rollback
  target is the last acknowledged chunk boundary.
* **rebuild and replay**: on a death the runner replays the epoch's seed
  matrix on the host (``storage.planner.replay_seed_matrix``: threefry
  is bit-equal on the CPU and the card) for the seeds not yet consumed,
  drops the old trainer's captured chunks, calls the caller's
  ``rebuild(remaining_seeds, num_survivors)`` (a new mesh of the
  survivors, on the same card for a one-process mesh, its stores and a
  ``shuffle=False`` loader over exactly those seeds), loads the rollback
  snapshot into the new trainer's model and optimizer and runs on. Every
  seed of the epoch trains exactly once.

``metrics.inc('recovery.rollbacks')`` counts the rollbacks, and every
rollback passes the ``recovery.roll_back`` fault site
(:meth:`FailoverRunner._roll_back_fault`). Each rollback opens a
``loader.failover`` span that the replacement trainer's epoch parents
under.
"""
import logging
from typing import Any, Callable, List, Optional

import numpy as np

from .. import metrics
from .. import random as trandom
from ..metrics import spans
from ..utils.faults import fault_point
from .checkpoint import ChunkCheckpointer, _load_train_state

logger = logging.getLogger('graphlearn_tpu_torch.recovery')


class ShardDeadError(RuntimeError):
  """A mesh shard was declared dead at a chunk boundary.

  Carries the rank, the liveness cause, and the index of the next
  chunk that was about to be enqueued (everything before it is acked)."""

  def __init__(self, rank: int, cause: str = '', chunk: int = 0):
    super().__init__(f'mesh shard rank {rank} declared dead at chunk '
                     f'{chunk}' + (f': {cause}' if cause else ''))
    self.rank = rank
    self.cause = cause
    self.chunk = chunk


def remaining_seeds(trainer, boundary_step: int) -> np.ndarray:
  """The epoch-ordered seeds not yet consumed at ``boundary_step`` (a
  chunk boundary) of ``trainer``'s current epoch, replayed on the host
  from the permutation stream the device prologue draws
  (``trainer._epochs`` is not advanced while the epoch is in flight, so
  the fold_in index is the aborted epoch's)."""
  from ..storage import planner
  loader = trainer.loader
  full_steps = len(loader)
  perm_key = trandom.fold_in(trainer._perm_key, trainer._epochs)
  seed_mat, mask_mat = planner.replay_seed_matrix(
      np.asarray(loader.input_seeds), perm_key, full_steps,
      trainer._batch_size, loader.shuffle, nparts=trainer._nparts)
  if trainer._nparts == 1:      # the planner's one-shard layout
    seed_mat, mask_mat = seed_mat[None], mask_mat[None]
  # [P, steps, B] -> epoch order [steps, P, B]; the pad slots of a ragged
  # tail are masked invalid and drop out: every seed appears once
  sm = seed_mat.transpose(1, 0, 2)[boundary_step:]
  mm = mask_mat.transpose(1, 0, 2)[boundary_step:]
  return np.asarray(sm[mm], dtype=np.int64)


def _holds(optimizer, model) -> bool:
  """True when ``optimizer`` steps exactly ``model``'s parameters."""
  held = {id(p) for g in optimizer.param_groups for p in g['params']}
  return held == {id(p) for p in model.parameters()}


class FailoverRunner:
  """Run one ``DistScanTrainer`` epoch with chunk-granular failover.

  Args:
    trainer: the initial ``loader.DistScanTrainer`` over the full mesh.
    rebuild: ``rebuild(remaining_seeds, num_survivors) -> trainer``: a
      replacement ``DistScanTrainer`` over the surviving shard count whose
      loader iterates exactly ``remaining_seeds`` with ``shuffle=False``
      (the seeds come in epoch order; a reshuffle would drop or repeat
      seeds). The factory owns the re-partitioning and the stores. Its
      model may be the old trainer's (its optimizer is then reused) or a
      new one (a new Adam takes the snapshot's state and rates).
    liveness: an object with ``dead_ranks() -> {rank: cause}``, polled at
      every chunk boundary; None disables detection (the runner then
      reacts only to a ``ShardDeadError`` raised by a hook).
    max_failovers: deaths tolerated in one epoch before the error is
      raised again.

  Usage::

      runner = FailoverRunner(trainer, rebuild, liveness=probe)
      state, losses, accs, report = runner.run_epoch(state)
  """

  def __init__(self, trainer, rebuild: Callable[[np.ndarray, int], Any],
               liveness=None, max_failovers: int = 1):
    self.trainer = trainer
    self.rebuild = rebuild
    self.liveness = liveness
    self.max_failovers = int(max_failovers)

  def _roll_back_fault(self):
    """The ``recovery.roll_back`` fault site, passed once per rollback."""
    fault_point('recovery.roll_back')

  def _install_liveness_hook(self, trainer):
    prev = trainer.stage_hook
    liveness = self.liveness
    handled = self._handled

    def hook(c, start, k):
      if prev is not None:
        prev(c, start, k)
      if liveness is not None:
        for rank, cause in liveness.dead_ranks().items():
          if rank not in handled:
            raise ShardDeadError(rank, cause, chunk=c)

    trainer.stage_hook = hook
    return prev

  def run_epoch(self, state, max_steps: Optional[int] = None):
    """One failure-tolerant epoch. Returns ``(state, losses, accs,
    report)``: losses and accs are host float32 arrays over every
    optimizer step taken (the acknowledged prefix, then the replayed
    rest: the step count can differ from an undisturbed epoch's when the
    batch grid re-slices over fewer shards, the seed coverage cannot),
    and ``report`` lists the failovers (rank, cause, rolled-back chunk,
    detected chunk, remaining seeds, survivors) and each segment's shard
    count and steps."""
    if max_steps is not None:
      raise ValueError('FailoverRunner covers full epochs: max_steps '
                       'would make "remaining seeds" ambiguous across '
                       'failover segments')
    trainer = self.trainer
    self._handled: set = set()
    survivors = trainer._nparts
    losses_parts: List[np.ndarray] = []
    accs_parts: List[np.ndarray] = []
    report = dict(failovers=[], segments=[])
    failures = 0
    state_in = state
    ovf0 = False
    open_spans = []
    try:
      while True:
        ckpt = ChunkCheckpointer(None, every=1, mem_every=1)
        prev_stage = self._install_liveness_hook(trainer)
        ckpt.attach(trainer)
        rolled = None
        try:
          # a shard already dead at the epoch's start: its whole share
          # fails over before anything is enqueued
          if self.liveness is not None:
            for rank, cause in self.liveness.dead_ranks().items():
              if rank not in self._handled:
                raise ShardDeadError(rank, cause, chunk=0)
          state_out, losses, accs = trainer.run_epoch(
              state_in, resume_overflow=ovf0)
          losses = losses.detach().cpu().numpy().astype(np.float32)
          accs = accs.detach().cpu().numpy().astype(np.float32)
          losses_parts.append(losses)
          accs_parts.append(accs)
          report['segments'].append(dict(num_parts=trainer._nparts,
                                         steps=int(losses.shape[0])))
          return (state_out, np.concatenate(losses_parts),
                  np.concatenate(accs_parts), report)
        except ShardDeadError as e:
          failures += 1
          self._handled.add(e.rank)
          if failures > self.max_failovers:
            raise
          self._roll_back_fault()
          metrics.inc('recovery.rollbacks')
          rolled = ckpt.latest_mem
          boundary = (int(rolled.meta['next_start'])
                      if rolled is not None else 0)
          k = trainer.chunk_size
          # the rollback's span: the replacement trainer's epoch.run span
          # parents under it (it stays open until the run ends)
          open_spans.append(spans.begin(
              'loader.failover', rank=e.rank, cause=str(e.cause)[:200],
              rolled_back_chunk=boundary // k, detected_chunk=e.chunk,
              survivors=survivors - 1))
          logger.warning(
              'shard rank %d died (%s): rolling back to chunk boundary %d '
              '(step %d) and re-slicing over %d survivors', e.rank, e.cause,
              boundary // k, boundary, survivors - 1)
          rem = remaining_seeds(trainer, boundary)
          if rolled is not None:
            losses_parts.append(np.asarray(rolled.arrays['losses']))
            accs_parts.append(np.asarray(rolled.arrays['accs']))
            ovf0 = bool(rolled.meta['overflow'])
          report['segments'].append(dict(num_parts=trainer._nparts,
                                         steps=boundary))
          report['failovers'].append(
              dict(rank=e.rank, cause=str(e.cause)[:200],
                   rolled_back_chunk=boundary // k, detected_chunk=e.chunk,
                   remaining_seeds=len(rem), survivors=survivors - 1))
          survivors -= 1
          if survivors < 1:
            raise
        finally:
          ckpt.detach()
          trainer.stage_hook = prev_stage
        # the old trainer's graphs go before the replacement captures its
        # own on the same card
        trainer._drop_graphs()
        trainer = self.rebuild(rem, survivors)
        if trainer.loader.shuffle:
          raise ValueError('rebuild() must return a shuffle=False loader '
                           'over the seeds it was handed: a reshuffle would '
                           'break exact-once coverage')
        if rolled is not None:
          if not _holds(state_in.optimizer, trainer.model):
            from ..models.train import create_train_state
            state_in = create_train_state(trainer.model)
          state_in = _load_train_state(trainer.model, state_in, rolled)
    finally:
      for sp in reversed(open_spans):
        spans.end(sp)
