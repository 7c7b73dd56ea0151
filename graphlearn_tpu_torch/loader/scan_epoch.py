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
anything back.

Chunk boundaries carry JAX's hooks: ``stage_hook(c, start, k)`` runs on
the host before chunk ``c`` is enqueued and ``ack_hook(c, start, k)``
right after, with ``self._chunk_carry`` (the state, the overflow flag,
the losses and accuracies so far) valid inside the call. The tensors in
it are live: the next chunk updates the parameters and Adam's tensors
in place, so a hook that keeps them copies them, on the current stream
(the trainer's), before it returns (``recovery.ChunkCheckpointer``
does). A hook runs between chunks, never inside a capture.
``run_epoch(start_step=, resume_overflow=)`` resumes an epoch at a chunk
boundary, and ``_recovery_config`` / ``_recovery_capture`` /
``_recovery_load`` / ``_recovery_advance`` are the protocol the
checkpointer drives (JAX's, with its padded-window branches: a snapshot
carries the padded table's seed and the loader's epoch count, and a
resumed epoch rebuilds the interrupted epoch's table).

Padded-window sampling: every epoch starts with the loader's
``_begin_epoch`` (no reseed on the first, one ``refresh_padded_table()``
on each later one), as in JAX. JAX re-fetches the table for each epoch's
program; a CUDA graph keeps the addresses it captured, so the sampler
rebuilds the table into the same tensors and every replay samples the
epoch's table.

Observability is JAX's, on the host only: each epoch writes one flight
record (``metrics.flight``, under ``GLT_RUN_LOG``) inside an
``epoch.run`` span, each chunk's enqueue runs under an ``epoch.chunk``
span, and the dispatch sites (``utils.trace.record_dispatch``: the seed
prologue, each chunk — a replay or an eager run — and the metrics
concat) and the captures (``metrics.programs``: a capture is the port's
compile, the chunk length and the static buffers' shapes its signature)
are counted. None of it reads the card or launches anything, and none
of it runs inside a capture.

``config=`` takes a tune artifact (``graphlearn_tpu_torch.tune()``), as
JAX's does (:func:`_resolve_tuned_config`): its topology is checked
against the trainer's, its dataset fingerprint against the loader's
dataset (a drifted graph is refused), its chunk K is the chunk size when
``chunk_size`` is not given, and its gather-kernel routing is stamped on
the dataset's feature store.

``GLT_STRICT=1`` (``utils.strict``) runs JAX's guarded region, the epoch
body (the seed matrix, the chunk loop, the losses' concat; not the
epoch-end overflow fetch nor the stats publish), under the card's sync
debug mode 'error': a host sync inside raises. The deliberate syncs in
it (the seed pool's first upload, a capture's entry) run under
``utils.strict.explicit``. A ``stage_hook`` or ``ack_hook`` runs inside
the region.

``DistScanTrainer`` (``graphlearn_tpu/loader/scan_epoch.py:536``) runs
the same frame over a collocated ``DistNeighborLoader``: the prologue
draws the ``[P, steps, B]`` seed and mask matrices on the device (JAX's
permutation, a cyclic ragged tail), and a chunk takes, per step and
shard, its seed row, its hop keys (``ops.dist_step_keys``: all of the
chunk's ``split(fold_in(base, count), P)[shard]`` keys split per hop in
one launch), the distributed hop loop, the cached feature lookup (its
``[L, 4]`` counters accumulate in a static buffer that is the store's
own accumulator while the epoch runs), the label gather and the
data-parallel step. One CUDA graph per chunk length, as here. The
fractional exchange width is chosen by a host read
(``distributed.verdict_syncs``), which a graph cannot make: with
``capture=True`` (the default on a card) every exchange must be full
width (``bucket_frac=None`` on the loader and its ``DistFeature``), or
the trainer refuses; ``capture=False`` runs the chunks eagerly with the
per-step loop's counted verdicts. Under an NCCL process group (one
shard per rank, ``init_multihost``) the chunk's collectives (the hops'
and the store's ``all_to_all_single``, the gradients' ``all_reduce``)
are captured with it: every rank runs the same chunk lengths in the same
order, so every rank captures the same graphs, and the first chunk runs
eagerly on every rank, which makes NCCL's communicators before any
capture. On the CPU (gloo) nothing is captured.

Usage::

    loader = NeighborLoader(ds, fanouts, idx, batch_size=B, shuffle=True,
                            drop_last=True, device=dev)
    trainer = ScanTrainer(loader, model, num_classes, chunk_size=32)
    state = models.train.create_train_state(model)
    state, losses, accs = trainer.run_epoch(state)   # on the device
"""
import contextlib
import gc
import hashlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..metrics import flight, programs, spans
from ..utils import strict
from ..utils.trace import record_dispatch
from .node_loader import NodeLoader
from .pipeline import (_RECOMPUTE_MSG, DistFusedEpochTrainer,
                       FusedEpochTrainer, shard_batches)

# chunk arguments that hold one row per step: their static buffers have
# ``chunk_size`` rows and a chunk of k steps fills the first k
_ROWS = ('seeds', 'masks')


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


@contextlib.contextmanager
def own_stream(stream):
  """Run on ``stream``, ordered after the work the caller's current
  stream holds and before what the caller enqueues next."""
  caller = torch.cuda.current_stream(stream.device)
  stream.wait_stream(caller)
  try:
    with torch.cuda.stream(stream):
      yield
  finally:
    caller.wait_stream(stream)


def capture_chunk(stream, body):
  """Capture ``body()`` into a CUDA graph on ``stream``: ``(graph, its
  outputs, the launches it recorded, host ms)``. The capture launches
  nothing, so the launches it counted are taken back (every replay adds
  them again). The collector does not run inside the capture: a dropped
  trainer's graph freed there (its reset) invalidates the capture, so
  garbage goes first and the collector waits until the capture ended."""
  before = ops.launch_counts()
  t0 = time.perf_counter()
  graph = torch.cuda.CUDAGraph()
  gc.collect()
  collecting = gc.isenabled()
  gc.disable()
  try:
    # torch.cuda.graph synchronizes the card on entry: a deliberate sync
    # (a capture is the port's compile, which JAX's guard allows)
    with strict.explicit(), torch.cuda.graph(
        graph, stream=stream, capture_error_mode='thread_local'):
      out = body()
  finally:
    if collecting:
      gc.enable()
  ms = (time.perf_counter() - t0) * 1e3
  after = ops.launch_counts()
  launches = {n: after[n] - before[n] for n in after}
  ops.add_launch_counts({n: -c for n, c in launches.items()})
  return graph, out, launches, ms


def _resolve_tuned_config(trainer_name: str, dataset, chunk_size,
                          config, topology: str = 'local') -> int:
  """The chunk size from an explicit value or a tune-artifact
  ``config=`` (JAX's ``_resolve_tuned_config``). An artifact is
  validated against the loader's dataset by fingerprint (a tuned config
  on a drifted graph refuses loudly) and against the trainer's topology:
  a non-local artifact only fits the scenario it was tuned for, while a
  local artifact's knobs (chunk K, kernel routing) are accepted by every
  trainer. Duck-typed (``validate_dataset`` + ``trainer_kwargs``), so
  the loader package does not import ``tune``."""
  if config is not None:
    art_topo = getattr(config, 'topology', 'local') or 'local'
    if art_topo not in ('local', topology):
      raise ValueError(
          f'{trainer_name}: tune artifact was tuned for topology '
          f'{art_topo!r}, but this trainer runs the {topology!r} '
          'scenario — per-topology knobs do not transfer; re-run '
          f'graphlearn_tpu_torch.tune(topology={topology!r}) '
          '(docs/tuning.md "Topology candidates")')
    config.validate_dataset(dataset, where=trainer_name)
    if chunk_size is None:
      chunk_size = config.trainer_kwargs()['chunk_size']
    if hasattr(config, 'apply_kernel_routing'):
      # kernel selection is an artifact choice: stamp the tuned gather
      # routing onto the dataset's feature store
      config.apply_kernel_routing(dataset)
  return 32 if chunk_size is None else int(chunk_size)


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


def capture_signature(k: int, buffers: dict, model, optimizer) -> tuple:
  """The program observatory's signature of a ``k``-step capture: the
  chunk length, each captured buffer's dtype and shape (by name), and
  what the graph freezes of the train state — the optimizer, the
  storage of the parameters and of its state, and each group's
  hyperparameters (one leaf each, so a recapture's diff names the one
  that changed)."""

  def digest(v) -> str:
    return hashlib.sha1(repr(v).encode()).hexdigest()[:12]

  frozen = _replay_signature(model, optimizer)
  leaves = [f'static:k={k}']
  leaves += [f'{n}:{programs.signature_of((t,), {})[0]}'
             for n, t in sorted(buffers.items())]
  leaves.append(f'static:optimizer={type(optimizer).__name__}'
                f'@{frozen[0]:x}')
  leaves.append(f'static:params@{digest(frozen[1])}')
  for i, (hyper, state) in enumerate(frozen[2]):
    leaves += [f'static:group{i}.{n}={v!r}' for n, v in hyper]
    leaves.append(f'static:group{i}.state@{digest(state)}')
  return tuple(leaves)


@contextlib.contextmanager
def epoch_records(emitter: str, epoch: int, config: dict, extra: dict):
  """An epoch's flight record and its ``epoch.run`` span, JAX's
  bracketing of ``ScanTrainer.run_epoch``: opened after the step
  arithmetic, so nothing before them can raise with either open, and
  closed once, in the finally, so a failed epoch still records
  (``completed=False``). Yields a dict the body sets ``steps`` and
  ``completed`` in. Host state only."""
  tok = flight.epoch_begin()
  sp = spans.begin('epoch.run', emitter=emitter, epoch=epoch)
  rec = {'steps': 0, 'completed': False}
  try:
    yield rec
  finally:
    spans.end(sp, steps=rec['steps'], completed=rec['completed'])
    flight.epoch_end(tok, emitter=emitter, epoch=epoch, steps=rec['steps'],
                     completed=rec['completed'], config=config,
                     extra=extra)


def _recovery_config_for(trainer) -> dict:
  """The snapshot-fingerprint config (``recovery/checkpoint.py``): the
  flight grouping config plus every knob that decides the replayed
  draws (sampler strategy, dedup, padded window, weighting, caps) and a
  digest of the seed pool. A copy of
  ``graphlearn_tpu/loader/scan_epoch.py:_recovery_config_for``: for the
  same loader configuration both packages fingerprint alike."""
  s = trainer._sampler
  cfg = trainer._flight_config()
  cfg.update(
      strategy=getattr(s, 'strategy', None),
      dedup=getattr(s, 'dedup', None),
      padded_window=getattr(s, 'padded_window', None),
      weighted=str(getattr(s, 'with_weight', None)),
      frontier_caps=str(getattr(s, 'frontier_caps', None)),
      seeds_sha=hashlib.sha1(
          np.ascontiguousarray(
              np.asarray(trainer.loader.input_seeds,
                         np.int64)).tobytes()).hexdigest()[:16])
  return cfg


class ScanTrainer(FusedEpochTrainer):
  """Runs an epoch as ``ceil(steps / chunk_size)`` chunks of steps.

  Args:
    loader: a homogeneous ``NeighborLoader`` with device-resident
      features and labels.
    model: any homogeneous model of the port over the loader's batches
      (a layered ``GraphSAGE`` or ``GAT`` matching the loader's layout,
      or a segment one), as JAX's takes any model.
    num_classes: label classes of the loss.
    chunk_size: K, steps per chunk (default: the artifact's tuned K with
      ``config``, else 32).
    perm_seed: base seed of the epoch permutation (default: the loader's
      seed).
    config: a tune artifact (``graphlearn_tpu_torch.tune()``): validated
      against the loader's dataset and this trainer's topology, it gives
      the chunk size when ``chunk_size`` is None and routes the feature
      store's gather.
    capture: run each chunk length as a captured CUDA graph (default:
      True on a card; a CPU loader refuses True). ``False`` is for a
      model that cannot be captured.
  """

  _NAME = 'ScanTrainer'
  # which tune() scenario this trainer runs: the config= topology check
  _TOPOLOGY = 'local'
  # the dispatch sites (record_dispatch and the program observatory):
  # the seed prologue, each chunk, the losses' concat
  _SITES = ('epoch_seeds', 'scan_chunk', 'metrics_concat')

  # chunk-boundary hooks (``recovery.ChunkCheckpointer`` attaches to
  # ack_hook): ``stage_hook(c, start, k)`` runs on the host before chunk
  # c is enqueued, ``ack_hook(c, start, k)`` right after it, with
  # ``self._chunk_carry`` valid inside the call. Both run on the
  # trainer's stream between chunks: a hook may enqueue copies there,
  # and must not synchronise if the epoch is to stay free of host syncs.
  stage_hook = None
  ack_hook = None
  # what one run_epoch call covers, in epochs (RunTrainer: E)
  _epochs_per_run = 1

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               chunk_size: Optional[int] = None,
               seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None, config=None,
               capture: Optional[bool] = None):
    on_card = loader.device.type == 'cuda'
    if capture is None:
      capture = on_card
    elif capture and not on_card:
      raise ValueError(f'capture=True needs a loader on a CUDA device, got '
                       f'{loader.device}: a CUDA graph captures the card\'s '
                       'launches')
    super().__init__(loader, model, num_classes, seed_labels_only)
    chunk_size = _resolve_tuned_config(self._NAME, loader.data, chunk_size,
                                       config, topology=self._TOPOLOGY)
    b = loader._batcher
    self._init_frame(loader.device, chunk_size, b.shuffle, b.drop_last,
                     b.seed if perm_seed is None else perm_seed, capture,
                     len(self._sampler.num_neighbors))

  def _init_frame(self, device, chunk_size: int, shuffle: bool,
                  drop_last: bool, perm_seed, capture: bool, n_hops: int):
    """The epoch frame's state: the chunking, the permutation stream and
    the captured graphs."""
    if chunk_size < 1:
      raise ValueError(f'chunk_size must be >= 1, got {chunk_size}')
    self.chunk_size = int(chunk_size)
    self._shuffle = shuffle
    self._drop_last = drop_last
    # the permutation stream is tagged off fold_in(2**32 - 1), where no
    # host step counter lands, so epoch e never reuses step e's words
    self._perm_key = trandom.fold_in(trandom.PRNGKey(perm_seed or 0),
                                     0xFFFFFFFF)
    self._epochs = 0
    self._seeds_dev = None
    self.capture = bool(capture)
    self._device = device
    self._n_hops = n_hops
    self._graphs = {}      # chunk length -> _ChunkGraph
    self._static = None    # the graphs' input buffers, after the warm-up
    self._signature = None  # _replay_signature of the graphs' state
    self._stream = None    # the capture stream (also the warm-up's)
    self._steps_dispatched = 0

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

  def _prologue(self, full_steps: int):
    """The seed matrix and mask the epoch's steps take their rows from."""
    return self._epoch_seeds(trandom.fold_in(self._perm_key, self._epochs),
                             full_steps)

  def _epoch_steps(self) -> int:
    # the batcher's arithmetic: the same step count as the per-step loop
    return len(self.loader._batcher)

  def _begin_epoch(self):
    """The loader's per-epoch start (the padded table's reseed)."""
    self.loader._begin_epoch()

  def run_epoch(self, state, max_steps: Optional[int] = None,
                start_step: int = 0, resume_overflow: bool = False):
    """One epoch. Returns ``(state, losses, accs)``, losses and accs as
    device tensors: read them once, after the epoch. The model's
    parameters are updated in place. ``max_steps`` truncates the epoch
    to that many steps (the seed matrix is still drawn for the whole
    epoch).

    ``start_step`` (a multiple of ``chunk_size``) resumes this epoch at
    that chunk boundary: the seed matrix is drawn for the whole epoch
    and the chunk at ``start`` takes the count ``count0 + start``, so
    with the sampler's counter, the epoch index and the train state
    restored the remaining chunks replay the interrupted epoch's
    (``recovery.ChunkCheckpointer.resume_epoch`` restores all three).
    ``resume_overflow`` starts the overflow flag at the one the
    interrupted prefix had. Losses and accs then cover
    ``[start_step, steps)``."""
    guarded, recompute = self.loader._overflow_epoch_start()
    if recompute:
      raise ValueError(_RECOMPUTE_MSG)
    self._begin_epoch()
    full_steps = self._epoch_steps()
    steps = full_steps
    truncated = max_steps is not None and max_steps < steps
    if truncated:
      steps = max_steps
    if start_step:
      if start_step % self.chunk_size != 0:
        raise ValueError(f'start_step={start_step} is not a chunk boundary '
                         f'(chunk_size={self.chunk_size}): resume only at '
                         'the boundaries checkpoints are taken at')
      if not 0 <= start_step < steps:
        raise ValueError(f'start_step={start_step} outside this epoch\'s '
                         f'{steps} steps')
    epoch_no = self._epochs
    extra = {'chunk_size': self.chunk_size, 'truncated': truncated}
    if steps <= 0:
      empty = torch.zeros(0, dtype=torch.float32, device=self._device)
      # zero-step epochs still record (the per-step loop writes a
      # steps=0 line), so flight epoch counts line up across drivers
      with epoch_records(self._NAME, epoch_no, self._flight_config(),
                         extra) as rec:
        rec['completed'] = True
        if guarded and not truncated:
          self._zero_step_overflow()
        self._epoch_end_publish()
      return state, empty, empty
    extra['start_step'] = start_step
    with epoch_records(self._NAME, epoch_no, self._flight_config(),
                       extra) as rec:
      # the resume point, until a chunk is enqueued: a body that fails
      # reads as the boundary it reached
      self._steps_dispatched = start_step
      try:
        # GLT_STRICT's region (utils.strict): the epoch body, not the
        # epoch-end overflow fetch nor the publish below
        with strict.strict_guards():
          state, losses, accs, ovf = self._run_epoch_body(
              state, steps, full_steps, start_step=start_step,
              resume_overflow=resume_overflow)
        rec['completed'] = True
        if guarded:
          self.loader._ovf_accum = ovf
          if not truncated:
            self.loader._finish_epoch_overflow()
      finally:
        rec['steps'] = steps if rec['completed'] else self._steps_dispatched
        # before the record: its feature fields are the published
        # counters (the distributed trainer's stores)
        self._epoch_end_publish()
    return state, losses, accs

  def _zero_step_overflow(self):
    """A zero-step epoch's overflow close (the distributed trainer's;
    the local trainers close nothing)."""

  def _epoch_end_publish(self):
    """Once per epoch, before its flight record: publish what the
    epoch accumulated on the card (nothing here; the distributed
    trainer's feature stores)."""

  @property
  def capture_ms(self) -> dict:
    """Host ms each captured chunk length took to capture."""
    return {k: g.capture_ms for k, g in self._graphs.items()}

  def _run_epoch_body(self, state, steps: int, full_steps: int,
                      start_step: int = 0, resume_overflow: bool = False):
    device = self._device
    if self._seeds_dev is None:
      with strict.explicit():   # the pool's one upload, a deliberate copy
        self._seeds_dev = torch.as_tensor(
            np.asarray(self.loader.input_seeds, dtype=np.int32)).to(device)
    record_dispatch(self._SITES[0])
    seed_mat, mask_mat = self._prologue(full_steps)
    base_key = trandom.to_device(self._sampler._key, device)
    count0 = self._sampler._call_count + 1
    if self._static is not None and \
        _replay_signature(self.model, state.optimizer) != self._signature:
      # the graphs froze another state: warm up again and recapture
      self._graphs, self._static, self._signature = {}, None, None
    losses, accs = [], []
    site_chunk = self._SITES[1]
    with self._capture_stream():
      ovf = torch.full((), bool(resume_overflow), dtype=torch.bool,
                       device=device)
      self._begin_run(full_steps)
      for start in range(start_step, steps, self.chunk_size):
        k = min(self.chunk_size, steps - start)
        c = start // self.chunk_size
        if self.stage_hook is not None:
          self.stage_hook(c, start, k)
        args = self._chunk_args(seed_mat, mask_mat, base_key,
                                count0 + start, start, k)
        record_dispatch(site_chunk)
        # the span times the host's enqueue of the chunk (a replay, or
        # with capture first the warm-up and each length's capture)
        with spans.span('epoch.chunk', start=start, k=k):
          if self._static is None:   # eager: the CPU, or the warm-up
            programs.default_program_registry().on_dispatch(site_chunk)
            loss, acc, overflow, _ = self._chunk(state, **args)
          else:
            loss, acc, overflow, _ = self._replay(state, **args)
        self._chunk_enqueued(c)
        if self.capture and self._static is None:
          self._static = {
              n: (t.new_zeros((self.chunk_size,) + t.shape[1:])
                  if n in _ROWS else t.clone()) for n, t in args.items()}
          self._signature = _replay_signature(self.model, state.optimizer)
        ovf = ovf | overflow
        losses.append(loss)
        accs.append(acc)
        state = state._replace(step=state.step + k)
        self._steps_dispatched = start + k
        if self.ack_hook is not None:
          self._chunk_carry = self._carry(
              state=state, ovf=ovf, losses=losses, accs=accs, steps=steps,
              full_steps=full_steps, start_step=start_step)
          self.ack_hook(c, start, k)
    self._end_run()
    if len(losses) > 1:
      record_dispatch(self._SITES[2])
    # keep the host fold_in stream aligned with what the run consumed
    self._sampler._call_count += steps
    self._epochs += self._epochs_per_run
    return state, torch.cat(losses), torch.cat(accs), ovf

  def _begin_run(self, full_steps: int):
    """Device state a run carries beyond the train state (none here)."""

  def _end_run(self):
    """After a run's last chunk (nothing here)."""

  def _chunk_enqueued(self, c: int):
    """Right after chunk ``c`` is enqueued (nothing here; the tiered
    trainer releases the chunk's staged slab)."""

  def _carry(self, **carry) -> dict:
    """The boundary carry an ``ack_hook`` reads."""
    return carry

  def _chunk_args(self, seed_mat, mask_mat, base_key, count: int,
                  start: int, k: int) -> dict:
    """The chunk's inputs (a captured graph's static buffers): its seed
    rows and mask, the base key, and the counter holding the count of
    its first step."""
    return dict(seeds=seed_mat[start:start + k],
                masks=mask_mat[start:start + k], base_key=base_key,
                counter=torch.full((), count, dtype=torch.int64,
                                   device=seed_mat.device))

  @contextlib.contextmanager
  def _capture_stream(self):
    """With ``capture``: run the epoch on the trainer's own stream (where
    the warm-up ran and the graphs are captured), ordered after the
    caller's work and before what the caller does next."""
    if not self.capture:
      yield
      return
    if self._stream is None:
      self._stream = torch.cuda.Stream(self._device)
    with own_stream(self._stream):
      yield

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

  def _replay(self, state, **args):
    """One chunk as a replay of its length's graph (captured on first
    use): the chunk's inputs go into the static buffers first, the
    outputs are copied out after."""
    k = args['seeds'].shape[0]
    st = self._static
    for n, t in args.items():
      (st[n][:k] if n in _ROWS else st[n]).copy_(t)
    g = self._graphs.get(k)
    reg = programs.default_program_registry()
    if g is None:
      g = self._graphs[k] = self._capture(state, k)
      sig = capture_signature(k, dict(self._capture_buffers(k)),
                              self.model, state.optimizer)
      # the capture is the port's compile (its dispatch is the replay)
      reg.on_compile(self._SITES[1], sig, g.capture_ms / 1e3)
    else:
      reg.on_dispatch(self._SITES[1])
    g.graph.replay()
    ops.add_launch_counts(g.launches)
    return g.losses.clone(), g.accs.clone(), g.ovf.clone(), g.keys

  def _capture_buffers(self, k: int):
    """``(name, tensor)`` of what a ``k``-step graph reads that a
    replay refills: the static buffers (and the tiered trainer's slab)."""
    return [(n, t[:k] if n in _ROWS else t) for n, t in self._static.items()]

  def _capture(self, state, k: int) -> _ChunkGraph:
    """Capture a ``k``-step chunk over the static buffers
    (:func:`capture_chunk`)."""
    args = {n: (t[:k] if n in _ROWS else t) for n, t in self._static.items()}
    graph, out, launches, ms = capture_chunk(
        self._stream, lambda: self._chunk(state, **args))
    return _ChunkGraph(graph, *out, launches, ms)

  # ------------------------------------------------- recovery protocol
  # (recovery/checkpoint.py ChunkCheckpointer)

  def _flight_config(self) -> dict:
    """The epoch program's static configuration (the JAX trainer's
    flight-record config, which the recovery fingerprint extends)."""
    return dict(trainer=self._NAME, batch_size=self._batch_size,
                chunk_size=self.chunk_size,
                fanouts=list(self._sampler.num_neighbors),
                shuffle=self._shuffle, drop_last=self._drop_last,
                num_classes=self.num_classes,
                seed=self.loader._batcher.seed)

  def _recovery_config(self) -> dict:
    return _recovery_config_for(self)

  def _recovery_capture(self, carry):
    """``(meta, device tensors)`` a boundary snapshot carries beyond the
    train state: the sampler's stream position (its base key and
    counter, still at the epoch-start value while the epoch runs) and,
    under padded-window sampling, the padded table's seed and the
    loader's count of epochs begun."""
    del carry
    meta = {'sampler': self._sampler.state_dict()}
    if getattr(self._sampler, 'padded_window', None) is not None:
      meta['padded'] = {'seed': int(self._sampler._padded_seed),
                        'epochs_started': int(self.loader._epochs_started)}
    return meta, {}

  def _recovery_load(self, meta, arrays):
    """Rewind this (fresh) trainer to the snapshot's epoch: the sampler's
    stream, the epoch index and, under padded-window sampling, the
    padded counters, set so that ``run_epoch``'s own ``_begin_epoch``
    lands the table on the interrupted epoch's seed (no reseed for a
    first epoch, one otherwise)."""
    del arrays   # the local trainer carries no extra device state
    self._sampler.load_state_dict(meta['sampler'])
    self._epochs = int(meta['epoch'])
    pad = meta.get('padded')
    if pad:
      es = int(pad['epochs_started'])
      first = es <= 1
      self.loader._epochs_started = 0 if first else es - 1
      self._sampler._reseed_padded(int(pad['seed']) - (0 if first else 1))

  def _recovery_advance(self, meta):
    """A snapshot of a finished epoch resumes past it: the counters land
    where the epoch's end left them, the padded counters at the values
    taken during that epoch (the next ``_begin_epoch`` reseeds onto the
    following epoch's table)."""
    self._sampler.load_state_dict(meta['sampler'])
    self._sampler._call_count += int(meta['steps'])
    self._epochs = int(meta['epoch']) + self._epochs_per_run
    pad = meta.get('padded')
    if pad:
      self.loader._epochs_started = int(pad['epochs_started'])
      self._sampler._reseed_padded(int(pad['seed']))


class DistScanTrainer(DistFusedEpochTrainer, ScanTrainer):
  """Runs a distributed epoch as ``ceil(steps / chunk_size)`` chunks of
  data-parallel steps over the mesh's shards.

  Args:
    loader: a collocated ``DistNeighborLoader`` with a ``DistFeature``
      store and node labels; on a typed loader (``('ntype', ids)``
      seeds) a store per node type, labels of the seed type, and one
      ``[L, 4]`` counter buffer per sampled, featured type.
    model: the model of one shard's batch (each shard runs it on its own
      batch; the gradients are averaged over the shards).
    num_classes: label classes of the loss.
    chunk_size: K, steps per chunk (default: the artifact's, else 32).
    perm_seed: base seed of the epoch permutation (default: the loader's
      seed). ``shuffle=False`` replays the loader's order (arange, a
      cyclic ragged tail) and its keys, so such an epoch equals
      ``run_epoch_steps``.
    config: a tune artifact of topology 'dist' (or a local one),
      validated against the ``DistGraph``'s stacked-partition
      fingerprint; it gives the chunk size when ``chunk_size`` is None.
    capture: one CUDA graph per chunk length (default: True on a card),
      on a one-process mesh or under an NCCL process group. Needs
      full-width exchanges (``bucket_frac=None``) and a card; refused
      otherwise, never switched off silently.
  """

  _NAME = 'DistScanTrainer'
  _TOPOLOGY = 'dist'
  _SITES = ('dist_epoch_seeds', 'dist_scan_chunk', 'dist_metrics_concat')

  def __init__(self, loader, model, num_classes: int,
               chunk_size: Optional[int] = None,
               seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None, config=None,
               capture: Optional[bool] = None):
    DistFusedEpochTrainer.__init__(self, loader, model, num_classes,
                                   seed_labels_only)
    chunk_size = _resolve_tuned_config(self._NAME, loader.data, chunk_size,
                                       config, topology=self._TOPOLOGY)
    device = self.mesh.device
    on_card = device.type == 'cuda'
    if capture is None:
      capture = on_card
    if capture:
      stores = ([(f'feature store {t!r}', f) for t, f in self._feat.items()]
                if self.is_hetero else [('feature store', self._feat)])
      fractional = [what for what, frac in (
          [('sampler', self._sampler.bucket_frac)] +
          [(what, f.bucket_frac) for what, f in stores] +
          [('label store', self._label_store.bucket_frac)])
          if frac is not None]
      if fractional:
        raise ValueError(
            f'capture=True with a fractional exchange ({", ".join(fractional)}'
            '): its width is picked by a host read of the overflow verdict, '
            'which a CUDA graph cannot make. Build the loader and its '
            'DistFeature with bucket_frac=None (full-width exchanges), or '
            'pass capture=False to run the chunks eagerly')
      if not on_card:
        raise ValueError(f'capture=True needs a mesh on a CUDA device, got '
                         f'{device}: a CUDA graph captures the card\'s '
                         'launches')
    # a typed shard key splits into hops * |edge types| keys (JAX's
    # _hetero_engine); ops.dist_step_keys draws them with that count
    n_keys = (self._sampler._hetero_key_count() if self.is_hetero
              else max(1, len(self._sampler.num_neighbors)))
    self._init_frame(device, chunk_size, loader.shuffle, loader.drop_last,
                     loader.seed if perm_seed is None else perm_seed,
                     capture, n_keys)
    # the stores' static [L, 4] counter buffers, by node type (None for
    # the homogeneous store)
    self._stats_buf = None
    self._sample_collate = self._make_sample_collate()

  def _stores(self) -> dict:
    """``{ntype or None: the feature store whose counters the chunk
    carries}``."""
    if self.is_hetero:
      return {t: self._feat[t] for t in self._feat_types}
    return {None: self._feat}

  # ------------------------------------------------------------ prologue

  def _seed_fn(self, seeds, key, steps: int):
    """The epoch's ``([P, steps, B] seeds, [P, steps, B] mask)`` (JAX's
    ``_build_seed_fn``): the permutation's prefix, or for a ragged tail
    the order padded by cycling it, the pad slots masked invalid."""
    n = seeds.shape[0]
    nparts, batch = self._nparts, self._batch_size
    dev = seeds.device
    order = (trandom.permutation(key, n, dev) if self._shuffle
             else torch.arange(n, dtype=torch.int32, device=dev))
    total = steps * nparts * batch
    if total <= n:
      ext = order[:total]
      maskf = torch.ones(total, dtype=torch.bool, device=dev)
    else:
      pad = order[torch.arange(total - n, device=dev) % n]
      ext = torch.cat([order, pad])
      maskf = torch.arange(total, device=dev) < n
    seed_mat = seeds[ext.long()].reshape(steps, nparts, batch)
    mask_mat = maskf.reshape(steps, nparts, batch)
    return seed_mat.transpose(0, 1), mask_mat.transpose(0, 1)

  def _epoch_seeds(self, key, steps: int):
    """Step-major ``[steps, P, B]`` rows for the chunks to slice."""
    seed_mat, mask_mat = self._seed_fn(self._seeds_dev, key, steps)
    return (seed_mat.transpose(0, 1).contiguous(),
            mask_mat.transpose(0, 1).contiguous())

  def _epoch_steps(self) -> int:
    return len(self.loader)

  def _begin_epoch(self):
    """No padded table on the distributed path."""

  def _zero_step_overflow(self):
    # the per-step loop's zero-batch epoch closes its guard too
    self.loader._finish_epoch_overflow()

  def _epoch_end_publish(self):
    """The stores' counters into the registry, also when the epoch
    failed (a dropped partial epoch publishes zeros), as JAX's trainer
    and the per-step loop do: one device read per store."""
    self.loader._publish_feature_stats()

  # --------------------------------------------------------------- chunk

  def _run_epoch_body(self, state, steps: int, full_steps: int,
                      start_step: int = 0, resume_overflow: bool = False):
    try:
      return super()._run_epoch_body(state, steps, full_steps,
                                     start_step=start_step,
                                     resume_overflow=resume_overflow)
    except BaseException:
      # a failed epoch drops its partial counts, as JAX does (its chunk
      # had donated them): a resume restores the boundary's from the
      # snapshot
      for store in self._stores().values():
        store.reset_stats()
      raise

  def _begin_run(self, full_steps: int):
    """The static counter buffers become the stores' accumulators for
    the run, starting from the counts the stores hold."""
    if self._stats_buf is None:
      self._stats_buf = {t: torch.zeros_like(f._stats_dev())
                         for t, f in self._stores().items()}
    for t, store in self._stores().items():
      st = store._stats_dev()
      buf = self._stats_buf[t]
      if st is not buf:
        buf.copy_(st)
      store._stats = buf

  def _carry(self, **carry) -> dict:
    carry['stats'] = (dict(self._stats_buf) if self.is_hetero
                      else self._stats_buf[None])
    return carry

  def _chunk(self, state, seeds, masks, base_key, counter):
    """The chunk's steps, eagerly (what a capture records): the keys of
    every step and shard in one launch, then per step the local shards'
    sample and collate, the counters into the static buffer and the
    data-parallel step."""
    k = seeds.shape[0]
    mesh = self.mesh
    keys = ops.dist_step_keys(base_key, counter, k, self._nparts,
                              self._n_hops)
    ovf = torch.zeros((), dtype=torch.bool, device=seeds.device)
    losses, accs = [], []
    for j in range(k):
      batch, overflow, stats = self._sample_collate(
          mesh.local_rows(seeds[j]), mesh.local_rows(masks[j]),
          mesh.local_rows(keys[j]))
      if self.is_hetero:
        for t, row in stats.items():
          self._stats_buf[t].add_(row)
      else:
        self._stats_buf[None].add_(stats)
      _, loss, acc = self._dp_step(state, shard_batches(batch))
      ovf = ovf | overflow
      losses.append(loss)
      accs.append(acc)
    return torch.stack(losses), torch.stack(accs), ovf, keys

  def _drop_graphs(self):
    """Forget the captured chunks (a failover's replaced trainer): the
    graphs, their static buffers and the gradients their capture
    allocated in the graphs' memory pool, which then goes back to the
    card."""
    self._graphs, self._static, self._signature = {}, None, None
    self.model.zero_grad(set_to_none=True)
    if self._device.type == 'cuda':
      import gc
      gc.collect()
      torch.cuda.empty_cache()

  # ------------------------------------------------- recovery protocol

  def _flight_config(self) -> dict:
    return dict(trainer=self._NAME, batch_size=self._batch_size,
                chunk_size=self.chunk_size,
                fanouts=list(self._sampler.num_neighbors),
                shuffle=self._shuffle, num_partitions=self._nparts,
                hetero=self.is_hetero, num_classes=self.num_classes,
                seed=self.loader.seed)

  def _recovery_capture(self, carry):
    """Beyond the train state: the sampler's stream position and the
    feature stores' ``[L, 4]`` counters (``stats:`` or ``stats:<ntype>``
    per typed store), so a resumed epoch's counters are exact, not just
    its losses."""
    stats = carry['stats']
    if self.is_hetero:
      dev = {f'stats:{t}': stats[t] for t in self._feat_types}
    else:
      dev = {'stats:': stats}
    return {'sampler': self._sampler.state_dict()}, dev

  def _recovery_load(self, meta, arrays):
    self._sampler.load_state_dict(meta['sampler'])
    self._epochs = int(meta['epoch'])
    for t, store in self._stores().items():
      key = 'stats:' if t is None else f'stats:{t}'
      if key in arrays:
        store._stats = torch.as_tensor(
            np.asarray(arrays[key], np.int32)).to(self._device)

  def _recovery_advance(self, meta):
    """A finished epoch's snapshot: the stream goes past it; its
    counters are not restored (they were counted before the crash)."""
    self._sampler.load_state_dict(meta['sampler'])
    self._sampler._call_count += int(meta['steps'])
    self._epochs = int(meta['epoch']) + self._epochs_per_run
