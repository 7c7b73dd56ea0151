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
  afterwards the sampler's counter advances by the steps taken. As in the
  JAX chunk, the counts are device values: each chunk derives its
  ``[K, n_hops, 2]`` hop keys on the device from the base key and a
  counter holding ``count0 + start`` (``ops.step_keys``, one launch).
- Losses, accuracies and the calibrated-caps overflow flag stay on the
  device; the flag is applied at epoch end through the loader's guard
  (a ``max_steps`` break leaves it to ``loader.check_overflow()``).
  ``overflow_policy='recompute'`` is refused.
- ``_epochs`` (folded into the permutation key) advances only when an
  epoch finishes, so a failed epoch's rerun redraws the same order.

The JAX package runs each K-step chunk as one compiled program
(``lax.scan`` under ``jax.jit``). Its counterpart here is one
``torch.cuda.CUDAGraph`` per chunk length (the full K and a tail),
captured once and replayed for every chunk of that length in every
epoch (``capture=True``, the default on a card). A graph's inputs are
static buffers (the chunk's ``[K, B]`` seed rows and mask, the base key,
the counter) that are refilled before each replay; its outputs (``[K]``
losses and accuracies, the overflow flag) are copied out after. Capture
needs a warm-up: the first chunk the trainer runs is eager, on the
capture stream, and makes Adam's state, the level kernel's scratch and
the libraries' workspaces; no step runs twice. The Adam must be
capturable (``models.train.create_train_state`` builds it so on a card).
A graph also freezes the optimizer it captured: its state tensors (the
moments and step counts), the parameters and each group's
hyperparameters (a float learning rate is a constant of the graph).
Every epoch starts by comparing them with those of the state it is
given; where they differ (another ``TrainState``, an
``optimizer.load_state_dict``, ``models.convert.adam_state_from_optax``,
a new rate) the graphs are dropped, the epoch's first chunk runs eagerly
as a new warm-up and the chunks are captured again. (A rate that changes
every epoch is cheaper as a tensor: a capturable Adam reads it from the
device.) A replay adds the launches its graph recorded to
``ops.launch_counts()``. A capture that fails raises; nothing falls back
to eager, so a model whose forward cannot be captured (one that reads a
value back, say) trains on a card with ``capture=False``, which runs
every chunk eagerly, step by step (the CPU always does). No step reads
anything back. Not ported: spans and flight
records, the program observatory, the tuned ``config=``, the stage/ack
hooks and ``start_step`` resume, and ``DistScanTrainer``.

Usage::

    loader = NeighborLoader(ds, fanouts, idx, batch_size=B, shuffle=True,
                            drop_last=True, device=dev)
    trainer = ScanTrainer(loader, model, num_classes, chunk_size=32)
    state = models.train.create_train_state(model)
    state, losses, accs = trainer.run_epoch(state)   # on the device
"""
import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from .node_loader import NodeLoader
from .pipeline import _RECOMPUTE_MSG, FusedEpochTrainer


class _ChunkGraph(NamedTuple):
  """A captured chunk: its graph, the tensors it writes on every replay
  (``[k]`` losses and accuracies, the overflow flag, the ``[k, n_hops,
  2]`` hop keys), the launches it makes and the capture's host ms."""
  graph: object
  losses: torch.Tensor
  accs: torch.Tensor
  ovf: torch.Tensor
  keys: torch.Tensor
  launches: dict
  capture_ms: float


def _replay_signature(model, optimizer) -> tuple:
  """What a captured chunk freezes of the train state: the optimizer
  object, the storage of the model's parameters and of each of the
  optimizer's state tensors, and each group's hyperparameters (a tensor
  one by its storage). A graph replayed under another signature would
  train stale tensors or at a stale rate."""

  def frozen(v):
    if torch.is_tensor(v):
      return ('tensor', v.data_ptr())
    return tuple(map(frozen, v)) if isinstance(v, (tuple, list)) else v

  groups = tuple(
      (tuple(sorted((k, frozen(v)) for k, v in g.items() if k != 'params')),
       tuple((p.data_ptr(), tuple(sorted(
           (k, frozen(v)) for k, v in optimizer.state.get(p, {}).items())))
             for p in g['params']))
      for g in optimizer.param_groups)
  return (id(optimizer), tuple(p.data_ptr() for p in model.parameters()),
          groups)


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
    capture: run each chunk length as a captured CUDA graph (default:
      True on a card; a CPU loader refuses True). ``False`` is for a
      model that cannot be captured.
  """

  _NAME = 'ScanTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               chunk_size: int = 32, seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None,
               capture: Optional[bool] = None):
    on_card = loader.device.type == 'cuda'
    if capture is None:
      capture = on_card
    elif capture and not on_card:
      raise ValueError(f'capture=True needs a loader on a CUDA device, got '
                       f'{loader.device}: a CUDA graph captures the card\'s '
                       'launches')
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
    self.capture = bool(capture)
    self._n_hops = len(self._sampler.num_neighbors)
    self._graphs = {}      # chunk length -> _ChunkGraph
    self._static = None    # the graphs' input buffers, after the warm-up
    self._signature = None  # _replay_signature of the graphs' state
    self._stream = None    # the capture stream (also the warm-up's)

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

  @property
  def capture_ms(self) -> dict:
    """Host ms each captured chunk length took to capture."""
    return {k: g.capture_ms for k, g in self._graphs.items()}

  def _run_epoch_body(self, state, steps: int, full_steps: int):
    device = self.loader.device
    if self._seeds_dev is None:
      self._seeds_dev = torch.as_tensor(
          np.asarray(self.loader.input_seeds, dtype=np.int32)).to(device)
    perm_key = trandom.fold_in(self._perm_key, self._epochs)
    seed_mat, mask_mat = self._epoch_seeds(perm_key, full_steps)
    base_key = trandom.to_device(self._sampler._key, device)
    count0 = self._sampler._call_count + 1
    if self._static is not None and \
        _replay_signature(self.model, state.optimizer) != self._signature:
      # the graphs froze another state: warm up again and recapture
      self._graphs, self._static, self._signature = {}, None, None
    losses, accs = [], []
    with self._capture_stream():
      ovf = torch.zeros((), dtype=torch.bool, device=device)
      for start in range(0, steps, self.chunk_size):
        k = min(self.chunk_size, steps - start)
        args = (seed_mat[start:start + k], mask_mat[start:start + k],
                base_key, torch.full((), count0 + start, dtype=torch.int64,
                                     device=device))
        # with capture, the first chunk runs eagerly: the warm-up
        run = self._chunk if self._static is None else self._replay
        loss, acc, overflow, _ = run(state, *args)
        if self.capture and self._static is None:
          seeds, masks, key, counter = args
          self._static = dict(
              seeds=seeds.new_zeros((self.chunk_size, seeds.shape[1])),
              masks=masks.new_zeros((self.chunk_size, masks.shape[1])),
              base_key=key.clone(), counter=counter.clone())
          self._signature = _replay_signature(self.model, state.optimizer)
        ovf = ovf | overflow
        losses.append(loss)
        accs.append(acc)
        state = state._replace(step=state.step + k)
    # keep the host fold_in stream aligned with what the epoch consumed
    self._sampler._call_count += steps
    self._epochs += 1
    return state, torch.cat(losses), torch.cat(accs), ovf

  @contextlib.contextmanager
  def _capture_stream(self):
    """With ``capture``: run the epoch on the trainer's own stream (where
    the warm-up ran and the graphs are captured), ordered after the
    caller's work and before what the caller does next."""
    if not self.capture:
      yield
      return
    device = self.loader.device
    if self._stream is None:
      self._stream = torch.cuda.Stream(device)
    caller = torch.cuda.current_stream(device)
    self._stream.wait_stream(caller)
    with torch.cuda.stream(self._stream):
      yield
    caller.wait_stream(self._stream)

  def _chunk(self, state, seeds, masks, base_key, counter):
    """Steps of one chunk, eagerly: the hop keys from the counter, then
    sample, collate and train each step. Returns ``([k] losses, [k]
    accs, overflow, [k, n_hops, 2] hop keys)``. What a capture
    records."""
    k = seeds.shape[0]
    keys = ops.step_keys(base_key, counter, k, self._n_hops)
    ovf = torch.zeros((), dtype=torch.bool, device=seeds.device)
    losses, accs = [], []
    for j in range(k):
      batch, overflow = self._sample_collate(seeds[j], masks[j], keys[j])
      _, loss, acc = self._train_step(state, batch)
      ovf = ovf | overflow
      losses.append(loss)
      accs.append(acc)
    return torch.stack(losses), torch.stack(accs), ovf, keys

  def _replay(self, state, seeds, masks, base_key, counter):
    """One chunk as a replay of its length's graph (captured on first
    use): the chunk's inputs go into the static buffers first, the
    outputs are copied out after."""
    k = seeds.shape[0]
    st = self._static
    st['seeds'][:k].copy_(seeds)
    st['masks'][:k].copy_(masks)
    st['base_key'].copy_(base_key)
    st['counter'].copy_(counter)
    g = self._graphs.get(k)
    if g is None:
      g = self._graphs[k] = self._capture(state, k)
    g.graph.replay()
    ops.add_launch_counts(g.launches)
    return g.losses.clone(), g.accs.clone(), g.ovf.clone(), g.keys

  def _capture(self, state, k: int) -> _ChunkGraph:
    """Capture a ``k``-step chunk over the static buffers. The capture
    launches nothing, so the launches it counted are taken back and
    added again by every replay."""
    st = self._static
    before = ops.launch_counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=self._stream,
                          capture_error_mode='thread_local'):
      out = self._chunk(state, st['seeds'][:k], st['masks'][:k],
                        st['base_key'], st['counter'])
    ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    launches = {n: after[n] - before[n] for n in after}
    ops.add_launch_counts({n: -c for n, c in launches.items()})
    return _ChunkGraph(graph, *out, launches, ms)
