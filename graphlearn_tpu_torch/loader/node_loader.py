"""Node-seed loader: seed batching, sampling, collation.

Counterpart of ``graphlearn_tpu/loader/node_loader.py``. ``SeedBatcher``
is the JAX package's numpy batcher, so the shuffled seed order is the
same in both packages for the same seed. ``NodeLoader`` samples and
collates each batch, under the calibrated-caps overflow guard
(``OverflowGuardMixin``) when the sampler runs the merge engine with
``frontier_caps``. The JAX loader's flight recorder and metrics are not
ported.
"""
from typing import Optional
import warnings

import numpy as np

from .. import ops
from ..data import Dataset
from ..sampler import NodeSamplerInput
from ..utils import resolve_device
from .transform import to_data


class SeedBatcher:
  """Shuffled, batched iteration over seed indices."""

  def __init__(self, num_seeds: int, batch_size: int, shuffle: bool,
               drop_last: bool, seed: Optional[int] = None):
    self.num_seeds = num_seeds
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.seed = seed
    self._rng = np.random.default_rng(seed)
    # mid-epoch resume bookkeeping (see state_dict below)
    self._epoch_start_state = self._rng.bit_generator.state
    self._consumed = 0
    self._pending_skip = 0

  def __iter__(self):
    # capture the stream position BEFORE the permutation draw: a
    # mid-epoch snapshot replays this epoch's permutation from here
    self._epoch_start_state = self._rng.bit_generator.state
    self._consumed = 0
    order = (self._rng.permutation(self.num_seeds) if self.shuffle
             else np.arange(self.num_seeds))
    skip, self._pending_skip = self._pending_skip, 0
    if skip >= len(self) > 0:
      # snapshot was taken at the epoch's end: the replayed epoch is
      # already complete — the permutation draw above advanced the
      # stream exactly as the original epoch did, so continue straight
      # into the next epoch. (len == 0 epochs yield nothing and must
      # not recurse.)
      yield from self.__iter__()
      return
    n_full = self.num_seeds // self.batch_size
    for i in range(n_full):
      if i < skip:
        self._consumed = i + 1
        continue
      # count BEFORE yielding: a snapshot taken while the consumer holds
      # batch i must record it as consumed (the trainer checkpoints
      # after finishing the step for the batch it was handed)
      self._consumed = i + 1
      yield order[i * self.batch_size:(i + 1) * self.batch_size]
    rem = self.num_seeds - n_full * self.batch_size
    if rem and not self.drop_last:
      self._consumed = n_full + 1
      yield order[n_full * self.batch_size:]

  def __len__(self):
    n_full = self.num_seeds // self.batch_size
    rem = self.num_seeds - n_full * self.batch_size
    return n_full + (1 if rem and not self.drop_last else 0)

  # -- checkpoint/resume ---------------------------------------------------
  # Mid-epoch granularity: the snapshot carries the PRNG state captured
  # at the CURRENT epoch's start plus how many batches were already
  # yielded. A restored batcher regenerates the identical permutation
  # and fast-forwards past the consumed batches, so training resumes at
  # the exact next batch (not the epoch start); subsequent epochs
  # continue the original stream.

  def state_dict(self):
    return {'rng_state': self._epoch_start_state,
            'consumed': int(self._consumed)}

  def load_state_dict(self, state):
    self._rng.bit_generator.state = state['rng_state']
    self._epoch_start_state = state['rng_state']
    self._pending_skip = int(state.get('consumed', 0))
    self._consumed = self._pending_skip


class OverflowGuardMixin:
  """Calibrated-caps overflow guard (``graphlearn_tpu/loader/
  node_loader.py:OverflowGuardMixin``).

  A batch whose new nodes exceed a calibrated frontier cap is truncated,
  and every sampled batch carries an on-device ``metadata['overflow']``
  flag. The loader applies ``overflow_policy``:

    'raise' (default) — accumulate the flag on the device (no host sync
        in the batch loop), fetch it once at epoch end, raise if any
        batch was truncated.
    'warn'      — the same, with ``warnings.warn``.
    'recompute' — read each batch's flag on the host and replay an
        offending batch at full capacities with the same PRNG key (the
        untruncated version of the same draw). One sync per batch.
    'off'       — no guard (``calibrate.check_no_overflow`` still works).
  """

  _OVERFLOW_POLICIES = ('raise', 'warn', 'recompute', 'off')

  def _init_overflow_policy(self, policy: str):
    if policy not in self._OVERFLOW_POLICIES:
      raise ValueError(f'overflow_policy {policy!r} not in '
                       f'{self._OVERFLOW_POLICIES}')
    self.overflow_policy = policy
    self.overflow_recomputes = 0   # full-capacity replays ('recompute')
    self._ovf_accum = None         # on-device accumulated flag
    self._full_sampler = None      # lazy uncapped clone

  def _overflow_guarded(self) -> bool:
    return getattr(self.sampler, 'clamped_exact', False) and \
        self.overflow_policy != 'off'

  def _overflow_epoch_start(self):
    """(guarded, recompute) for this epoch. Drops a flag left by an
    earlier epoch that was left early: its verdict was forfeited and must
    not taint this one."""
    self._ovf_accum = None
    guarded = self._overflow_guarded()
    return guarded, guarded and self.overflow_policy == 'recompute'

  def _accumulate_overflow(self, out):
    flag = out.metadata.get('overflow')
    if flag is None:
      return
    self._ovf_accum = (flag if self._ovf_accum is None
                       else self._ovf_accum | flag)

  def _batch_overflowed(self, out) -> bool:
    flag = out.metadata.get('overflow')
    return flag is not None and bool(flag)

  def _replay_sampler(self):
    if self._full_sampler is None:
      self._full_sampler = self.sampler.uncapped_clone()
    return self._full_sampler

  def check_overflow(self) -> bool:
    """True iff a batch sampled since the current epoch started tripped
    the overflow flag (one device fetch). For consumers that leave an
    epoch early: the automatic check runs only when the iterator ends."""
    if self._ovf_accum is None:
      return False
    return bool(self._ovf_accum)

  def _finish_epoch_overflow(self):
    if self._ovf_accum is None:
      return
    flag, self._ovf_accum = self._ovf_accum, None
    if bool(flag):
      msg = (
          'calibrated frontier_caps overflowed this epoch: at least one '
          'batch was truncated (quietly biased). Re-calibrate with more '
          'slack (sampler.calibrate.estimate_frontier_caps), or pass '
          "overflow_policy='recompute' to replay offending batches at "
          'full capacities (exact, one host sync per batch).')
      if self.overflow_policy == 'warn':
        warnings.warn(msg, stacklevel=2)
      else:
        raise RuntimeError(msg)


class NodeLoader(OverflowGuardMixin):
  """Sample-and-collate loader over seed nodes.

  ``device=None`` means the card; it must be the dataset's device.
  ``seed_labels_only`` gathers labels for the seed block only.
  ``overflow_policy`` is the calibrated-caps guard's
  (``OverflowGuardMixin``).
  """

  def __init__(self, data: Dataset, node_sampler, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, device=None,
               seed: Optional[int] = None, seed_labels_only: bool = False,
               overflow_policy: str = 'raise'):
    self.device = resolve_device(device)
    if data.device != self.device:
      raise ValueError(f'dataset lives on {data.device}, loader asked for '
                       f'{self.device}')
    self.data = data
    self.sampler = node_sampler
    self.seed_labels_only = seed_labels_only
    if isinstance(input_nodes, tuple):
      self.input_type, self.input_seeds = input_nodes
    else:
      self.input_type, self.input_seeds = None, input_nodes
    self.input_seeds = np.asarray(self.input_seeds).reshape(-1)
    self.batch_size = batch_size
    self._init_overflow_policy(overflow_policy)
    self._batcher = SeedBatcher(len(self.input_seeds), batch_size, shuffle,
                                drop_last, seed)

  def __len__(self):
    return len(self._batcher)

  def __iter__(self):
    guarded, recompute = self._overflow_epoch_start()
    for idx in self._batcher:
      inp = NodeSamplerInput(self.input_seeds[idx], self.input_type)
      if recompute:
        key = self.sampler._next_key()
        out = self.sampler.sample_from_nodes(inp, batch_cap=self.batch_size,
                                             key=key)
        if self._batch_overflowed(out):
          self.overflow_recomputes += 1
          out = self._replay_sampler().sample_from_nodes(
              inp, batch_cap=self.batch_size, key=key)
      else:
        out = self.sampler.sample_from_nodes(inp, batch_cap=self.batch_size)
        if guarded:
          self._accumulate_overflow(out)
      yield self._collate_fn(out)
    if guarded and not recompute:
      self._finish_epoch_overflow()

  def _collate_fn(self, out):
    feats = id2i = None
    if self.data.node_features is not None:
      feats, id2i = self.data.node_features.device_table()
    res = ops.collate_batch(out.node, out.num_nodes, out.row, out.col,
                            feats, id2i, self.data.node_labels, None, None,
                            label_cap=(self.batch_size
                                       if self.seed_labels_only else None))
    return to_data(out, res['x'], res['y'], node_mask=res['node_mask'],
                   edge_index=res['edge_index'])
