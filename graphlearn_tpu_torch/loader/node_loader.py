"""Node-seed loader: seed batching, sampling, collation.

Counterpart of ``graphlearn_tpu/loader/node_loader.py``. ``SeedBatcher``
is the JAX package's numpy batcher, so the shuffled seed order is the
same in both packages for the same seed. ``NodeLoader`` samples and
collates each batch (node features and labels, and the edge features of
``with_edge`` batches), under the calibrated-caps overflow guard
(``OverflowGuardMixin``) when the sampler runs the merge engine with
``frontier_caps``. Under a padded-window sampler every epoch after the
first starts with a reseed of the padded table (``_begin_epoch``).
``state_dict`` / ``load_state_dict`` resume mid-epoch (the batcher and
the sampler's stream). Each epoch of ``__iter__`` writes one flight
record (``metrics.flight``, under ``GLT_RUN_LOG``) and each batch runs
under a ``glt_batch`` step annotation, as in JAX.
"""
from typing import Optional
import warnings

import numpy as np
import torch

from .. import ops
from ..data import Dataset
from ..metrics import flight
from ..sampler import NodeSamplerInput
from ..utils import resolve_device, step_annotation
from .transform import to_data, to_hetero_data


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
    if policy == 'recompute' and \
        getattr(getattr(self, 'sampler', None), 'is_hetero', False):
      # typed batches draw their (hop, edge type) keys from the sampler's
      # own stream: no per-batch key exists to replay a truncated draw
      # graftlint: allow[hetero-gate] no replayable hetero batch key
      raise ValueError(
          "overflow_policy='recompute' is homogeneous-only (hetero "
          'batches have no replayable per-batch key); use '
          "'raise'/'warn', or recalibrate with more slack")
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
    flag = flag.any()        # a distributed batch's flag is one per shard
    self._ovf_accum = (flag if self._ovf_accum is None
                       else self._ovf_accum | flag)

  def _batch_overflowed(self, out) -> bool:
    flag = out.metadata.get('overflow')
    return flag is not None and bool(flag.any())

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


def loader_device(to_device, device):
  """The loader's device from JAX's ``to_device`` or the port's
  ``device=`` alias (None means the card)."""
  if to_device is not None and device is not None and \
      torch.device(to_device) != torch.device(device):
    raise ValueError(f'to_device={to_device!r} and device={device!r} '
                     'disagree')
  return resolve_device(device if to_device is None else to_device)


class NodeLoader(OverflowGuardMixin):
  """Sample-and-collate loader over seed nodes.

  ``to_device`` (or its alias ``device=``; None means the card) must be
  the dataset's device. ``with_edge`` is carried by the sampler.
  ``seed_labels_only`` gathers labels for the seed block only;
  ``collect_features=False`` gathers no node features.
  ``overflow_policy`` is the calibrated-caps guard's
  (``OverflowGuardMixin``).
  """

  seed_labels_only = False
  collect_features = True

  def __init__(self, data: Dataset, node_sampler, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, to_device=None,
               seed: Optional[int] = None, seed_labels_only: bool = False,
               overflow_policy: str = 'raise', device=None):
    del with_edge   # carried by the sampler
    self._check_device(data, loader_device(to_device, device))
    self.data = data
    self.sampler = node_sampler
    self.seed_labels_only = seed_labels_only
    self.collect_features = collect_features
    if isinstance(input_nodes, tuple):
      self.input_type, self.input_seeds = input_nodes
    else:
      self.input_type, self.input_seeds = None, input_nodes
    self.input_seeds = np.asarray(self.input_seeds).reshape(-1)
    self.batch_size = batch_size
    self._init_overflow_policy(overflow_policy)
    self._epochs_started = 0     # epochs begun (the padded reseed's count)
    self._batcher = SeedBatcher(len(self.input_seeds), batch_size, shuffle,
                                drop_last, seed)

  def _check_device(self, data: Dataset, device: torch.device):
    self.device = device
    if data.device != self.device:
      raise ValueError(f'dataset lives on {data.device}, loader asked for '
                       f'{self.device}')

  def __len__(self):
    return len(self._batcher)

  def state_dict(self):
    """Mid-epoch resume state: the seed batcher's (the shuffle stream and
    the batches consumed) and the sampler's PRNG stream position."""
    state = self._batcher.state_dict()
    state['sampler'] = self.sampler.state_dict()
    return state

  def load_state_dict(self, state):
    self._batcher.load_state_dict(state)
    if 'sampler' in state:
      self.sampler.load_state_dict(state['sampler'])

  def _begin_epoch(self):
    """The per-epoch padded-table reseed (``graphlearn_tpu/loader/
    node_loader.py:_begin_epoch``): none on the first epoch, one
    ``refresh_padded_table()`` on every later one, so rows with deg >
    window expose a fresh random window-subset each epoch. A no-op for
    other samplers. The one counter lives here, so every epoch loop
    (``__iter__``, ``ScanTrainer``, ``OverlappedTrainer``) shares it."""
    if getattr(self.sampler, 'padded_window', None) is not None:
      if self._epochs_started > 0:
        self.sampler.refresh_padded_table()
      self._epochs_started += 1

  def __iter__(self):
    self._begin_epoch()
    # overflow-policy resolve BEFORE the flight bracket opens: a config
    # error raising here must not leave a permanently-open record
    guarded, recompute = self._overflow_epoch_start()
    tok = flight.epoch_begin()
    steps, completed = 0, False
    try:
      for i, idx in enumerate(self._batcher):
        with step_annotation('glt_batch', i):
          inp = NodeSamplerInput(self.input_seeds[idx], self.input_type)
          if recompute:
            key = self.sampler._next_key()
            out = self.sampler.sample_from_nodes(
                inp, batch_cap=self.batch_size, key=key)
            if self._batch_overflowed(out):
              self.overflow_recomputes += 1
              out = self._replay_sampler().sample_from_nodes(
                  inp, batch_cap=self.batch_size, key=key)
          else:
            out = self.sampler.sample_from_nodes(
                inp, batch_cap=self.batch_size)
            if guarded:
              self._accumulate_overflow(out)
          batch = self._collate_fn(out)
        yield batch
        steps += 1
      completed = True
      if guarded and not recompute:
        self._finish_epoch_overflow()
    finally:
      # one flight record per per-step epoch: host-side counter deltas
      # only, nothing launched or read back
      flight.end_for(
          self, tok, steps=steps, completed=completed,
          config=dict(loader=type(self).__name__,
                      batch_size=self.batch_size,
                      shuffle=self._batcher.shuffle,
                      drop_last=self._batcher.drop_last,
                      seed=self._batcher.seed,
                      num_neighbors=getattr(self.sampler,
                                            'num_neighbors', None)))

  def _collate_fn(self, out):
    """The fused collate over device-resident tables; a store with a host
    part (no ``device_table()``) is read through its own lookup, the
    hot/cold gather, as in the JAX loader."""
    if getattr(self.sampler, 'is_hetero', False):
      return self._hetero_collate(out)
    feats = id2i = efeats = None
    nfeat = self.data.node_features if self.collect_features else None
    ndt = nfeat.device_table() if nfeat is not None else None
    if ndt is not None:
      feats, id2i = ndt
    efeat = (getattr(self.data, 'edge_features', None)
             if out.edge is not None else None)
    edt = efeat.device_table() if efeat is not None else None
    if edt is not None:
      efeats = edt[0]
    res = ops.collate_batch(out.node, out.num_nodes, out.row, out.col,
                            feats, id2i, self.data.node_labels, efeats,
                            out.edge,
                            label_cap=(self.batch_size
                                       if self.seed_labels_only else None))
    x = res['x'] if ndt is not None or nfeat is None else nfeat[out.node]
    ef = (res['edge_attr'] if edt is not None or efeat is None
          else efeat[out.edge])
    return to_data(out, x, res['y'], ef,
                   node_mask=res['node_mask'], edge_index=res['edge_index'])

  def _hetero_collate(self, out):
    """Typed collate: per featured node type one row gather of its buffer
    (``ops.gather_rows``: one launch of the row-gather kernel on the
    card) or, for a store with a host part, the store's own hot/cold
    lookup; labels per labelled type, by the engine's rounded seed cap
    for the input type only under ``seed_labels_only`` (seeds lead its
    buffer; other types carry no seed block)."""
    x = y = None
    if self.collect_features and self.data.node_features is not None:
      x = {}
      for t, buf in out.node.items():
        store = self.data.get_node_feature(t)
        if store is None:
          continue
        dt = store.device_table()
        x[t] = (ops.gather_rows(dt[0], dt[1], buf) if dt is not None
                else store[buf])
    if self.data.node_labels is not None:
      y = {}
      for t, buf in out.node.items():
        labels = self.data.get_node_label(t)
        if labels is None:
          continue
        if self.seed_labels_only:
          if t != out.input_type:
            continue
          cap = (out.batch[t].shape[0]
                 if out.batch is not None and t in out.batch
                 else self.batch_size)
          buf = buf[:cap]
        y[t] = labels[torch.clamp(buf, min=0).long()]
    return to_hetero_data(out, x, y)
