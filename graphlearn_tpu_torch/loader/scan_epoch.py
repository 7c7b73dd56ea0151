"""Epoch as a loop over K-step chunks: ``ScanTrainer``.

Counterpart of ``graphlearn_tpu/loader/scan_epoch.py:ScanTrainer``, with
the same contract:

- The epoch's seed order is drawn on the device: ``random.permutation``
  (bit-equal to ``jax.random.permutation``) under the key
  ``fold_in(fold_in(PRNGKey(perm_seed), 2**32 - 1), epoch)``, gathered
  into a ``[steps, B]`` seed matrix with a validity mask; a ragged tail
  is padded with node id 0 (the host loop's padding) and masked.
  ``shuffle=False`` takes the seeds in order.
- Global step ``g`` samples with ``fold_in(base_key, count0 + g)``,
  ``count0`` being the sampler's call count at epoch start plus one, so a
  shuffle=False epoch replays the per-step loader loop's draws exactly;
  afterwards the sampler's counter advances by the steps taken.
- Losses, accuracies and the calibrated-caps overflow flag stay on the
  device; the flag is applied at epoch end through the loader's guard
  (a ``max_steps`` break leaves it to ``loader.check_overflow()``).
  ``overflow_policy='recompute'`` is refused.
- ``_epochs`` (folded into the permutation key) advances only when an
  epoch finishes, so a failed epoch's rerun redraws the same order.

The JAX package runs each K-step chunk as one scanned program. PyTorch
runs the chunk eagerly, step by step; the chunk is kept as the unit a
CUDA graph would capture. No step reads anything back on purpose. Not
ported: spans and flight records, the program observatory, the tuned
``config=``, the stage/ack hooks and ``start_step`` resume, and
``DistScanTrainer``.

Usage::

    loader = NeighborLoader(ds, fanouts, idx, batch_size=B, shuffle=True,
                            drop_last=True, device=dev)
    trainer = ScanTrainer(loader, model, num_classes, chunk_size=32)
    state = models.train.create_train_state(model)
    state, losses, accs = trainer.run_epoch(state)   # on the device
"""
from typing import Optional

import numpy as np
import torch

from .. import random as trandom
from .node_loader import NodeLoader
from .pipeline import _RECOMPUTE_MSG, FusedEpochTrainer


class ScanTrainer(FusedEpochTrainer):
  """Runs an epoch as ``ceil(steps / chunk_size)`` chunks of steps.

  Args:
    loader: a homogeneous ``NeighborLoader`` with device-resident
      features and labels.
    model: the layered ``GraphSAGE`` matching the loader's layout.
    num_classes: label classes of the loss.
    chunk_size: K, steps per chunk.
    perm_seed: base seed of the epoch permutation (default: the loader's
      seed).
  """

  _NAME = 'ScanTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               chunk_size: int = 32, seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None):
    super().__init__(loader, model, num_classes, seed_labels_only)
    if chunk_size < 1:
      raise ValueError(f'chunk_size must be >= 1, got {chunk_size}')
    self.chunk_size = int(chunk_size)
    self._shuffle = loader._batcher.shuffle
    self._drop_last = loader._batcher.drop_last
    if perm_seed is None:
      perm_seed = loader._batcher.seed or 0
    # the permutation stream is tagged off fold_in(2**32 - 1), where no
    # host step counter lands, so epoch e never reuses step e's words
    self._perm_key = trandom.fold_in(trandom.PRNGKey(perm_seed), 0xFFFFFFFF)
    self._epochs = 0
    self._seeds_dev = None

  def _epoch_seeds(self, key, steps: int):
    """The prologue: ``([steps, B] seed matrix, [steps, B] mask)``."""
    seeds = self._seeds_dev
    n, batch = seeds.shape[0], self._batch_size
    order = (trandom.permutation(key, n, seeds.device) if self._shuffle
             else torch.arange(n, dtype=torch.int32, device=seeds.device))
    total = steps * batch
    if total <= n:       # drop_last: the permutation's prefix
      order = order[:total]
      mask = torch.ones(total, dtype=torch.bool, device=seeds.device)
    else:                # ragged tail, masked invalid
      order = torch.cat([order, order.new_zeros(total - n)])
      mask = torch.arange(total, device=seeds.device) < n
    seed_mat = torch.where(mask, seeds[order.long()], 0)
    return seed_mat.reshape(steps, batch), mask.reshape(steps, batch)

  def _epoch_steps(self) -> int:
    # the batcher's arithmetic: the same step count as the per-step loop
    return len(self.loader._batcher)

  def run_epoch(self, state, max_steps: Optional[int] = None):
    """One epoch. Returns ``(state, losses, accs)``, losses and accs as
    ``[steps]`` device tensors: read them once, after the epoch. The
    model's parameters are updated in place. ``max_steps`` truncates the
    epoch to that many steps (the seed matrix is still drawn for the
    whole epoch)."""
    guarded, recompute = self.loader._overflow_epoch_start()
    if recompute:
      raise ValueError(_RECOMPUTE_MSG)
    full_steps = self._epoch_steps()
    steps = full_steps
    truncated = max_steps is not None and max_steps < steps
    if truncated:
      steps = max_steps
    if steps <= 0:
      empty = torch.zeros(0, dtype=torch.float32, device=self.loader.device)
      return state, empty, empty
    state, losses, accs, ovf = self._run_epoch_body(state, steps,
                                                    full_steps)
    if guarded:
      self.loader._ovf_accum = ovf
      if not truncated:
        self.loader._finish_epoch_overflow()
    return state, losses, accs

  def _run_epoch_body(self, state, steps: int, full_steps: int):
    device = self.loader.device
    if self._seeds_dev is None:
      self._seeds_dev = torch.as_tensor(
          np.asarray(self.loader.input_seeds, dtype=np.int32)).to(device)
    perm_key = trandom.fold_in(self._perm_key, self._epochs)
    seed_mat, mask_mat = self._epoch_seeds(perm_key, full_steps)
    base_key = self._sampler._key
    count0 = self._sampler._call_count + 1
    ovf = torch.zeros((), dtype=torch.bool, device=device)
    losses, accs = [], []
    for start in range(0, steps, self.chunk_size):
      k = min(self.chunk_size, steps - start)
      state, ovf = self._run_chunk(state, ovf, seed_mat, mask_mat, base_key,
                                   count0, start, k, losses, accs)
    # keep the host fold_in stream aligned with what the epoch consumed
    self._sampler._call_count += steps
    self._epochs += 1
    return state, torch.stack(losses), torch.stack(accs), ovf

  def _run_chunk(self, state, ovf, seed_mat, mask_mat, base_key, count0,
                 start, k, losses, accs):
    """Steps ``[start, start + k)``: sample, collate and train each."""
    for g in range(start, start + k):
      key = trandom.fold_in(base_key, count0 + g)
      batch, overflow = self._sample_collate(seed_mat[g], mask_mat[g], key)
      state, loss, acc = self._train_step(state, batch)
      ovf = ovf | overflow
      losses.append(loss)
      accs.append(acc)
    return state, ovf
