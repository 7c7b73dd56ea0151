"""RemoteScanTrainer: server-client epochs as chunks of K steps.

Counterpart of ``graphlearn_tpu/distributed/remote_scan.py``. The
per-batch remote path (``RemoteDistNeighborLoader`` and a train step per
batch) moves one batch per RPC poll; here the unit of exchange is the
K-batch block:

* **Servers produce K-batch blocks.** Each sampling server replays the
  same counter-addressed stream the per-batch mp worker draws
  (``distributed/block_producer.py``) and stacks K consecutive batches
  into one frame, built on its dataset's device and brought to its host
  in one copy.
* **The client double-buffers blocks over the RPC.** A
  :class:`RemoteBlockStager` worker fetches block ``c+1`` while chunk
  ``c`` trains, and sends a ``block_produce`` for ``c+1`` ahead of the
  ``block_fetch`` of ``c``, so the server builds the next frame while
  this one's bytes are on the wire. The worker copies each fetched
  frame's training payload into a pinned host slot (the slots are made
  once, at the first frame), laid out step-major so that the first k
  steps of a chunk are one contiguous prefix.
* **One upload, one replay a chunk.** On the trainer's stream the
  dispatch thread copies the slot's prefix into one static device buffer
  (one host-to-device copy, without blocking the host), records an event
  (the slot goes back to the worker only once it has completed) and
  replays the CUDA graph captured for that chunk length, which runs the
  K train steps of ``models.train`` over views of the buffer. The next
  frame's copy is enqueued on the same stream after the replay, so it
  cannot overwrite what the replay reads. A tail chunk has its own
  graph; the first chunk runs eagerly as the capture's warm-up; a bf16
  frame is upcast inside the graph. With ``capture=False`` (and always
  on the CPU) the chunk runs the same steps eagerly over the same
  buffer. Losses and accuracies stay on the device until the epoch's
  end.
* **Acks and failover by chunk.** A block is acked when its chunk is
  enqueued; a dead server's unfetched blocks are re-pointed at replay
  producers on survivors (``_handle_dead_rank``, ``_replay_pid``) that
  rebuild the same bytes, since a block is a pure function of (share,
  config, epoch, range); frames already on the client survive their
  server. ``shuffle=True`` fails over as exactly: the server's epoch
  permutation is epoch-addressed.
* **Degrade to sync, never corrupt.** A failed or slow prefetch falls
  back to a synchronous fetch of the same block on the dispatch thread
  (``remote.prefetch_miss``): the same bytes, slower.

With ``shuffle=False`` and ``wire_dtype=None`` the losses and the final
parameters equal the per-batch remote path's (one server,
``num_workers=1``), tail batch, tail chunk and later epochs included.
``stage_hook`` / ``ack_hook`` carry the other trainers' contract, so
``recovery.ChunkCheckpointer`` attaches unchanged and a crash resumes at
a block boundary.

Usage::

    gtt.distributed.init_client(1, 1, 0, [(host, port)])
    opts = gtt.distributed.RemoteDistSamplingWorkerOptions(server_rank=0)
    trainer = gtt.distributed.RemoteScanTrainer(
        [15, 10, 5], seeds, model, num_classes, batch_size=1024,
        chunk_size=32, worker_options=opts, seed=0)
    state = gtt.models.train.create_train_state(model)
    state, losses, accs = trainer.run_epoch(state)

Deliberate divergences: the optimizer is in the ``TrainState`` (no
``tx``); ``device=`` (where the model trains, the card by default) and
``capture=`` come last. ``config=`` (a tune artifact) is JAX's
(:func:`_resolve_remote_config`). Under ``GLT_STRICT`` the epoch body is
the guarded region (``utils.strict``).
Observability is the other trainers': one flight record in an
``epoch.run`` span per epoch, an ``epoch.chunk`` span per chunk's
enqueue, a ``remote.block_fetch`` span per fetched block (the worker
thread's: it joins the epoch's trace through the adopted context), a
``loader.failover`` span per dead server, and the dispatch sites
(``remote_epoch_begin``, ``remote_scan_chunk``, ``remote_metrics_concat``)
and captures (``metrics.programs``).
"""
import contextlib
import dataclasses
import gc
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import metrics, ops
from ..loader.scan_epoch import (_ChunkGraph, _replay_signature,
                                 capture_chunk, capture_signature,
                                 epoch_records, own_stream)
from ..metrics import programs, spans
from ..storage.staging import _POLL_S
from ..typing import to_edge_type
from ..utils import resolve_device, strict, trace
from ..utils.trace import record_dispatch
from ..utils.faults import fault_point
from .dist_loader import _norm_num_neighbors, _split_input_type
from .resilience import NO_RETRY, DeadlineExceeded, ServerDeadError
from .tenancy import with_backpressure

logger = logging.getLogger('graphlearn_tpu_torch.loader')

#: exception classes a block fetch may die with when its server is gone;
#: anything else is a genuine remote error and surfaces
_DEAD_EXCS = (ConnectionError, TimeoutError, OSError, DeadlineExceeded,
              ServerDeadError)

# byte alignment of each key in a step's slot layout
_ALIGN = 256


class _Slab:
  __slots__ = ('frame', 'ready', 'error', 't_done', 'slot', 'meta',
               'fetch_ms', 'pin_ms')

  def __init__(self):
    self.frame = None     # the fetched frame (until it is packed)
    self.ready = threading.Event()
    self.error: Optional[BaseException] = None
    self.t_done: Optional[float] = None
    self.slot = None      # the slot the worker packed it into
    self.meta = None      # the frame's ack keys, once packed
    self.fetch_ms = None
    self.pin_ms = None


class _Slot:
  """A host byte buffer (pinned on a card) holding one frame's training
  payload, and the event after which its last copy out has completed."""
  __slots__ = ('buf', 'chunk', 'release')

  def __init__(self, nbytes: int, pin: bool):
    self.buf = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=pin)
    self.chunk = None
    self.release = None


class RemoteBlockStager:
  """One background worker prefetching block frames ahead of the chunk
  dispatch loop (the remote twin of ``storage.staging.ChunkStager``).

  ``fetch_fn(chunk_index)`` makes the RPC; it reads the trainer's
  schedule at call time, so a failover that re-points a chunk at a
  survivor is honoured by the worker and the synchronous fallback alike.
  ``pack_fn(frame, slot_buf) -> meta`` (optional) copies a fetched
  frame's training payload into a slot's buffer and returns the small
  keys the trainer still reads (its ack ids); ``slot_bytes_fn(frame)``
  sizes the slots at the first frame. Without ``pack_fn`` the stager
  hands the frames over as they came (JAX's stager).
  """

  def __init__(self, fetch_fn: Callable[[int], dict], max_ahead: int = 2,
               timeout_s: float = 30.0, pack_fn: Optional[Callable] = None,
               slot_bytes_fn: Optional[Callable] = None, pin: bool = False):
    if max_ahead < 1:
      raise ValueError('max_ahead must be >= 1')
    self.fetch_fn = fetch_fn
    self.max_ahead = int(max_ahead)
    self.timeout_s = float(timeout_s)
    self._pack_fn = pack_fn
    self._slot_bytes_fn = slot_bytes_fn
    self._pin = bool(pin)
    self._num_chunks = 0
    self._slabs: Dict[int, _Slab] = {}
    self._slots: List[_Slot] = []
    self._lock = threading.Lock()
    self._q: 'queue.Queue' = queue.Queue()
    self._worker: Optional[threading.Thread] = None
    self._stop = False
    self._next_submit = 0
    self._gen = 0
    self.degraded = False   # a worker fetch failed this epoch
    self._ctx = None        # the epoch's span context, adopted by _loop
    # per refill of a slot: (chunk, the previous occupant's release event
    # had completed) -- True by construction
    self.refills: List[tuple] = []
    self.wait_ms: Dict[int, float] = {}

  # ------------------------------------------------------------ lifecycle

  def begin_epoch(self, num_chunks: int, start_chunk: int = 0):
    """Install this epoch's chunk count and prime the first
    ``max_ahead`` fetches; a resume passes ``start_chunk``."""
    if not 0 <= start_chunk <= num_chunks:
      raise ValueError(f'start_chunk={start_chunk} outside the '
                       f'{num_chunks}-chunk epoch')
    with self._lock:
      self._num_chunks = int(num_chunks)
      self._slabs = {}
      self._gen += 1
      self._next_submit = int(start_chunk)
      self.degraded = False
      self.refills = []
      self.wait_ms = {}
      for s in self._slots:
        s.chunk = None     # an earlier epoch's chunks are all acked
      # the caller's (epoch-root) span context: the worker's fetch spans
      # (remote.block_fetch, tenant.throttle) parent under the epoch
      # tree instead of floating as orphans
      self._ctx = spans.wire_context()
    self._ensure_worker()
    for _ in range(min(self.max_ahead, num_chunks - int(start_chunk))):
      self._submit_next()

  @property
  def slot_bytes(self) -> int:
    """Host bytes the slots hold (pinned on a card)."""
    with self._lock:
      return sum(s.buf.numel() for s in self._slots)

  def close(self):
    self._stop = True
    self._q.put(None)
    w = self._worker
    if w is not None:
      w.join(timeout=5.0)
    self._worker = None
    self._stop = False
    # drain leftovers, so a stale None cannot end the next epoch's
    # fresh worker on its first pop
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass

  def _ensure_worker(self):
    if self._worker is not None and self._worker.is_alive():
      return
    self._worker = threading.Thread(target=self._loop, daemon=True,
                                    name='gtt-remote-block-stager')
    self._worker.start()

  def _submit_next(self):
    with self._lock:
      c = self._next_submit
      if c >= self._num_chunks:
        return
      self._next_submit = c + 1
      self._slabs[c] = _Slab()
      gen = self._gen
    self._q.put((gen, c))

  # --------------------------------------------------------------- worker

  def _loop(self):
    while True:
      item = self._q.get()
      if item is None or self._stop:
        return
      gen, c = item
      with self._lock:
        slab = self._slabs.get(c) if gen == self._gen else None
        ctx = self._ctx
      if slab is None or slab.ready.is_set():
        continue   # the epoch moved on, or failover already failed it
      try:
        t0 = time.perf_counter()
        fault_point('remote.block_fetch')
        with spans.adopt(ctx):
          frame = self.fetch_fn(c)
        slab.fetch_ms = (time.perf_counter() - t0) * 1e3
        metrics.observe('remote.block_stage_ms', slab.fetch_ms)
        if self._pack_fn is None:
          slab.frame = frame
        else:
          slot = self._claim(c, slab, frame)
          if slot is None:
            continue     # acked (a degraded take) or closed meanwhile
          # held from here on: the ack releases it even if packing fails
          slab.slot = slot
          t1 = time.perf_counter()
          slab.meta = self._pack_fn(frame, slot.buf)
          slab.pin_ms = (time.perf_counter() - t1) * 1e3
          del frame
      except BaseException as e:   # a chaos raise must not kill later blocks
        slab.error = e
        self.degraded = True
      finally:
        slab.t_done = time.perf_counter()
        slab.ready.set()

  def _claim(self, c: int, slab: _Slab, frame: dict) -> Optional[_Slot]:
    """Slot ``c % max_ahead`` for chunk ``c``, once its last chunk is
    acked and that chunk's copy event has completed (the slots are made
    at the first frame). None if ``c`` was acked or the stager closed."""
    with self._lock:
      if not self._slots:
        nbytes = int(self._slot_bytes_fn(frame))
        self._slots = [_Slot(nbytes, self._pin)
                       for _ in range(self.max_ahead)]
      slot = self._slots[c % len(self._slots)]
    while True:
      with self._lock:
        if self._slabs.get(c) is not slab:
          return None
        free = slot.chunk is None
        ev = slot.release
      if free and (ev is None or ev.query()):
        with self._lock:
          self.refills.append((c, ev is None or ev.query()))
          slot.chunk, slot.release = c, None
        return slot
      if self._stop:
        return None
      time.sleep(_POLL_S)

  # ------------------------------------------------------------- consumer

  def has_frame(self, c: int) -> bool:
    """True when chunk ``c``'s frame is already on the client; such
    frames survive the death of the server that produced them."""
    with self._lock:
      slab = self._slabs.get(c)
    return (slab is not None and slab.ready.is_set() and
            slab.error is None and
            (slab.frame is not None or slab.slot is not None))

  def fail_pending(self, chunks: List[int], exc: BaseException):
    """Failover: mark not-yet-staged slabs failed, so :meth:`take` goes
    to the synchronous path (with the re-pointed descriptor) at once
    instead of waiting out the timeout against a dead server."""
    with self._lock:
      slabs = [self._slabs.get(c) for c in chunks]
    for slab in slabs:
      if slab is not None and not slab.ready.is_set():
        slab.error = exc
        slab.ready.set()

  def take(self, c: int) -> _Slab:
    """Chunk ``c``'s slab. Blocks up to ``timeout_s`` for the worker,
    then degrades to a synchronous fetch of the same block
    (``remote.prefetch_miss``): a slab holding the frame itself. The
    synchronous fetch may raise (a dead server): the trainer fails over
    and calls take() again; the ring advances only in :meth:`ack`."""
    t0 = time.perf_counter()
    with self._lock:
      slab = self._slabs.get(c)
    ok = slab is not None and slab.ready.wait(self.timeout_s)
    self.wait_ms[c] = (time.perf_counter() - t0) * 1e3
    if ok and slab.error is None and \
        (slab.frame is not None or slab.slot is not None):
      return slab
    self.degraded = True
    metrics.inc('remote.prefetch_miss')
    out = _Slab()
    t1 = time.perf_counter()
    out.frame = self.fetch_fn(c)
    out.fetch_ms = (time.perf_counter() - t1) * 1e3
    return out

  def ack(self, c: int, event=None):
    """Chunk ``c`` is enqueued: free its slab and, with ``event`` (the
    CUDA event after its upload), hand its slot back once the event has
    completed; then pull the next chunk forward."""
    with self._lock:
      slab = self._slabs.pop(c, None)
      slot = slab.slot if slab is not None else None
      if slot is not None and slot.chunk == c:
        slot.chunk, slot.release = None, event
    self._submit_next()


class _Layout:
  """Where each training key of one step lies in a slot: byte offset,
  shape and dtype per key, steps back to back (step-major), so the first
  k steps of a chunk are one prefix of ``k * step_bytes``."""

  def __init__(self, arrays: Dict[str, np.ndarray], k_max: int):
    self.keys = []
    off = 0
    for name, a in arrays.items():
      shape = tuple(a.shape[1:])
      nbytes = int(np.prod(shape, dtype=np.int64)) * a.dtype.itemsize
      self.keys.append((name, off, shape, a.dtype, nbytes))
      off += -(-nbytes // _ALIGN) * _ALIGN
    self.step_bytes = max(off, _ALIGN)
    self.k_max = int(k_max)

  @property
  def nbytes(self) -> int:
    return self.step_bytes * self.k_max

  def check(self, arrays: Dict[str, np.ndarray]):
    got = [(n, tuple(a.shape[1:]), a.dtype) for n, a in arrays.items()]
    want = [(n, s, d) for n, _, s, d, _ in self.keys]
    if got != want:
      raise ValueError(f'a block frame\'s training payload {got} differs '
                       f'from the stream\'s closed shapes {want}')

  def pack(self, arrays: Dict[str, np.ndarray], buf: torch.Tensor):
    """Copy a frame's ``[k, ...]`` arrays into ``buf``, step-major."""
    self.check(arrays)
    flat = buf.numpy()
    k = next(iter(arrays.values())).shape[0]
    for name, off, _, _, nbytes in self.keys:
      a = np.ascontiguousarray(arrays[name])
      src = a.reshape(k, -1).view(np.uint8)
      for j in range(k):
        base = j * self.step_bytes + off
        flat[base:base + nbytes] = src[j]

  def views(self, dev_buf: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """Per step, ``{key: tensor view of dev_buf}``."""
    out = []
    for j in range(self.k_max):
      step = {}
      for name, off, shape, dtype, nbytes in self.keys:
        base = j * self.step_bytes + off
        tdtype = _torch_dtype(dtype)
        step[name] = dev_buf[base:base + nbytes].view(tdtype).view(shape)
      out.append(step)
    return out


def _torch_dtype(np_dtype):
  return torch.from_numpy(np.zeros((0,), np_dtype)).dtype


def _norm_fans(f):
  """Canonical comparison form of a fanout spec: per-etype dict fanouts
  normalize to sorted string keys (tuned artifacts round-trip etype keys
  through JSON as strings)."""
  if isinstance(f, dict):
    from ..typing import as_str
    return {as_str(tuple(et)) if isinstance(et, (tuple, list))
            else str(et): [int(k) for k in v]
            for et, v in sorted(f.items(), key=lambda kv: str(kv[0]))}
  return [int(k) for k in f]


def _resolve_remote_config(name: str, config, fanouts,
                           batch_size: int) -> dict:
  """Validate a tune-artifact ``config=`` against the remote scenario and
  return its tuned block knobs (empty without a config), as JAX's does:
  the topology must be 'remote' or a generic 'local' artifact, and the
  artifact's fanouts and batch size must be the stream's. The client
  holds no dataset to recompute the fingerprint against: the artifact is
  accepted on the tune side's validation, with a warning."""
  if config is None:
    return {}
  art_topo = getattr(config, 'topology', 'local') or 'local'
  if art_topo not in ('local', 'remote'):
    raise ValueError(
        f'{name}: tune artifact was tuned for topology {art_topo!r}, '
        "but this trainer runs the 'remote' scenario — per-topology "
        'knobs do not transfer; re-run graphlearn_tpu_torch.tune('
        "topology='remote') (docs/tuning.md)")
  choices = getattr(config, 'choices', None) or {}
  tuned_fans = choices.get('fanouts')
  if tuned_fans is not None and \
      _norm_fans(tuned_fans) != _norm_fans(fanouts):
    raise ValueError(
        f'{name}: tune artifact pins fanouts {tuned_fans} but '
        f'this trainer streams at {_norm_fans(fanouts)} — the '
        'block frames were sized for a different sampling shape '
        '(docs/tuning.md)')
  tuned_bs = choices.get('batch_size')
  if tuned_bs is not None and int(tuned_bs) != int(batch_size):
    raise ValueError(
        f'{name}: tune artifact pins batch_size={int(tuned_bs)} but '
        f'this trainer streams at batch_size={int(batch_size)} '
        '(docs/tuning.md)')
  if getattr(config, 'dataset', None) is not None:
    import warnings
    warnings.warn(
        f'{name}: the remote client holds no dataset to recompute '
        'the artifact fingerprint against — tuned config accepted on '
        'the tune-side validation only', RuntimeWarning, stacklevel=3)
  if art_topo == 'remote' and hasattr(config, 'topology_kwargs'):
    kw = config.topology_kwargs()
    return {k: kw[k] for k in ('block_ahead', 'block_wire_dtype')
            if k in kw}
  return {}


class RemoteScanTrainer:
  """Chunked epochs over sampling-server block streams (module
  docstring). Scope: supervised node classification with collected
  features and labels, homogeneous or typed (typed seeds select typed
  block streams whose shapes come from the stream's ``CapacityPlan``).

  Args:
    num_neighbors: fanouts (a list, or a per-edge-type dict).
    input_nodes: seed ids, or ``('ntype', ids)`` on a typed graph (split
      across the servers in rank order, as the remote loaders split
      them).
    model: the model; it owns its parameters, on ``device``.
    num_classes: label classes of the loss.
    batch_size: per optimizer step.
    chunk_size: K, batches per block and chunk.
    shuffle: the servers' epoch-addressed shuffle; ``False`` also holds
      the equality with the per-batch remote path.
    drop_last: drop the ragged tail batch.
    worker_options: ``RemoteDistSamplingWorkerOptions``: ``server_rank``,
      the heartbeat and failover tunables, ``block_wire_dtype`` /
      ``block_ahead`` / ``block_timeout``, the tenant fields.
    seed: sampling seed, folded per server (``seed * 7919 + i``).
    config: a tune artifact (``graphlearn_tpu_torch.tune(topology=
      'remote')``, or a local one): gives the chunk size when
      ``chunk_size`` is None and the tuned ``block_ahead`` /
      ``block_wire_dtype`` (over the worker options'); a mismatched
      topology, fanouts or batch size is refused.
    device: where the model trains (default: the card).
    capture: one CUDA graph per chunk length (default: True on a card; the
      CPU refuses True). ``False`` runs the chunks eagerly.
  """

  _NAME = 'RemoteScanTrainer'

  # chunk-boundary hooks: ``stage_hook(c, start, k)`` before chunk c is
  # enqueued, ``ack_hook(c, start, k)`` right after, with
  # ``self._chunk_carry`` valid inside the call (its tensors are live:
  # copy them on the trainer's stream before returning)
  stage_hook = None
  ack_hook = None

  def __init__(self, num_neighbors, input_nodes, model, num_classes: int,
               batch_size: int = 64, chunk_size: Optional[int] = None,
               shuffle: bool = False, drop_last: bool = False,
               collect_features: bool = True, worker_options=None,
               seed: Optional[int] = None, config=None, device=None,
               capture: Optional[bool] = None):
    from ..models import train as train_lib
    from ..sampler import NodeSamplerInput, SamplingConfig, SamplingType
    from . import dist_client
    from .resilience import Heartbeat
    tuned_block = _resolve_remote_config(
        self._NAME, config, _norm_num_neighbors(num_neighbors), batch_size)
    if chunk_size is None:
      chunk_size = int(config.trainer_kwargs()['chunk_size']) \
          if config is not None else 32
    if chunk_size < 1:
      raise ValueError(f'chunk_size must be >= 1, got {chunk_size}')
    if not collect_features:
      raise ValueError(f'{self._NAME} needs collect_features=True: the '
                       'chunk trains on the block frames\' features')
    self.device = resolve_device(device)
    on_card = self.device.type == 'cuda'
    if capture is None:
      capture = on_card
    elif capture and not on_card:
      raise ValueError(f'capture=True needs a CUDA device, got '
                       f'{self.device}: a CUDA graph captures the card\'s '
                       'launches')
    for name, p in model.named_parameters():
      if p.device.type != self.device.type or \
          (p.device.index or 0) != (self.device.index or 0):
        raise ValueError(f'the model\'s parameter {name!r} is on '
                         f'{p.device}, the trainer trains on {self.device}')
    self.capture = bool(capture)
    input_type, input_nodes = _split_input_type(input_nodes)
    self._input_type = input_type
    self.model = model
    self.num_classes = num_classes
    self.chunk_size = int(chunk_size)
    self.batch_size = int(batch_size)
    self.input_seeds = np.asarray(input_nodes).reshape(-1)
    self.seed = seed
    self._shuffle = bool(shuffle)
    self._drop_last = bool(drop_last)
    opts = worker_options
    self._opts = opts
    self._dist_client = dist_client
    ranks = opts.server_rank if opts and opts.server_rank is not None \
        else [0]
    if isinstance(ranks, int):
      ranks = [ranks]
    self.server_ranks = list(ranks)
    self._wire_dtype = opts.block_wire_dtype if opts else None
    self._max_ahead = opts.block_ahead if opts else 2
    # the artifact's tuned block knobs are the signed assignment: a tuned
    # value overrides the worker options' (hand-pick without config=)
    if 'block_wire_dtype' in tuned_block:
      self._wire_dtype = tuned_block['block_wire_dtype']
    if 'block_ahead' in tuned_block:
      self._max_ahead = int(tuned_block['block_ahead'])
    self._fetch_timeout = opts.block_timeout if opts else 30.0
    self._failover_enabled = opts.failover if opts else True
    self._tenant = opts.tenant if opts else None
    self._tenant_priority = opts.tenant_priority if opts else None
    self._tenant_weight = opts.tenant_weight if opts else None
    self._base_weight = float(self._tenant_weight or 1.0)
    self._bp_budget = opts.backpressure_budget if opts else 120.0
    self._config = SamplingConfig(
        SamplingType.NODE, _norm_num_neighbors(num_neighbors),
        self.batch_size, self._shuffle, self._drop_last, False,
        collect_features, False, False, 'out', seed)
    base_key = (opts.worker_key if opts and opts.worker_key
                else f'rscan{os.getpid()}-{id(self):x}')
    self._worker_key = base_key
    # one block stream per server, shares and seed folds as the per-batch
    # remote loaders split them
    splits = np.array_split(self.input_seeds, len(self.server_ranks))
    self._streams = []
    for i, (rank, split) in enumerate(zip(self.server_ranks, splits)):
      share = (NodeSamplerInput(split, input_type=self._input_type)
               if self._input_type is not None else split)
      cfg_i = dataclasses.replace(self._config,
                                  seed=(seed or 0) * 7919 + i)
      pid = with_backpressure(
          lambda rank=rank, share=share, cfg_i=cfg_i, i=i:
          dist_client.request_server(
              rank, 'create_block_producer', share, cfg_i,
              self._wire_dtype, worker_key=f'{base_key}/blk/{i}',
              idempotent=True, **self._tenant_kwargs()),
          describe=f'create_block_producer stream {i} rank {rank}',
          budget_s=self._bp_budget, tenant=self._tenant)
      nb = dist_client.request_server(
          rank, 'block_producer_num_batches', pid, idempotent=True)
      self._streams.append(dict(rank=rank, pid=pid, seeds=share,
                                cfg=cfg_i, num_batches=int(nb)))
    self._active_ranks = list(self.server_ranks)
    self._current_chunk = -1
    self._dead_ranks: Dict[int, str] = {}
    self._replay_pids: Dict[tuple, int] = {}
    self._epochs = 0
    self._schedule: List[dict] = []
    self._layout: Optional[_Layout] = None
    self._stager = RemoteBlockStager(
        self._fetch_block, max_ahead=self._max_ahead,
        timeout_s=self._fetch_timeout, pack_fn=self._pack,
        slot_bytes_fn=self._slot_bytes, pin=on_card)
    hb_interval = opts.heartbeat_interval if opts else 1.0
    hb_miss = opts.heartbeat_miss if opts else 3

    def probe(rank):
      dist_client.request_server(rank, 'heartbeat',
                                 timeout=max(hb_interval, 2.0),
                                 idempotent=True, retry_policy=NO_RETRY)

    self._heartbeat = Heartbeat(self.server_ranks, probe,
                                interval=hb_interval,
                                miss_threshold=hb_miss)
    self._hb_started = False
    self._train_step, _ = train_lib.make_train_step(model, num_classes)
    self._dev_buf = None       # the static device buffer
    self._steps_view = None    # per step, its keys' views of it
    self._graphs: Dict[int, _ChunkGraph] = {}
    self._warm = False         # the capture's warm-up chunk has run
    self._signature = None
    self._stream = None
    self._steps_dispatched = 0
    self._chunk_log: List[dict] = []
    self.uploads = 0           # host-to-device copies of the last epoch
    self.replays = 0           # graph replays of the last epoch
    self.last_overflow = None  # [bool] device flag of the last epoch
    self.last_epoch_seed_ids = None   # host ack record of the last epoch

  # ------------------------------------------------------------- schedule

  def __len__(self) -> int:
    return sum(st['num_batches'] for st in self._streams)

  def _block_boundaries(self) -> List[int]:
    """Global steps where blocks begin: the only ``start_step`` resume
    points (multiples of K with one server)."""
    bounds, step0 = [], 0
    for st in self._streams:
      nb = st['num_batches']
      bounds.extend(step0 + b for b in range(0, nb, self.chunk_size))
      step0 += nb
    return bounds

  def _block_schedule(self, steps: int, epoch: int) -> List[dict]:
    """Chunk descriptors in epoch order: the streams' shares back to back
    (for shuffle=False their concatenation is the seed sequence), each
    cut into K-batch blocks and a tail. A rank already known dead is
    re-pointed at survivors up front; a rank outside the active set
    (``set_block_ranks``) hands its blocks to replay producers on active
    ranks."""
    descs, step0 = [], 0
    for i, st in enumerate(self._streams):
      nb = st['num_batches']
      for b0 in range(0, nb, self.chunk_size):
        gstep = step0 + b0
        if gstep >= steps:
          break
        k = min(self.chunk_size, nb - b0, steps - gstep)
        descs.append(dict(stream=i, rank=st['rank'], pid=st['pid'],
                          epoch=epoch, start=b0, k=k, step0=gstep))
      step0 += nb
    if self._dead_ranks:
      survivors = [r for r in self._active_ranks
                   if r not in self._dead_ranks] or \
                  [r for r in self.server_ranks
                   if r not in self._dead_ranks]
      if not survivors:
        raise RuntimeError('no live sampling server to start the '
                           f'epoch: dead={self._dead_ranks}')
      moved = 0
      for d in descs:
        if d['rank'] in self._dead_ranks:
          self._require_failover()
          surv = survivors[moved % len(survivors)]
          d['pid'] = self._replay_pid(surv, d['stream'])
          d['rank'] = surv
          moved += 1
    inactive = [r for r in self.server_ranks
                if r not in self._active_ranks and
                r not in self._dead_ranks]
    if inactive:
      targets = [r for r in self._active_ranks
                 if r not in self._dead_ranks]
      moved = 0
      for d in descs:
        if d['rank'] in inactive:
          tgt = targets[moved % len(targets)]
          d['pid'] = self._replay_pid(tgt, d['stream'])
          d['rank'] = tgt
          moved += 1
      if moved:
        metrics.inc('tenant.rebalanced_blocks', moved)
    return descs

  # -------------------------------------------------------- block fetch

  def _fetch_block(self, c: int) -> dict:
    """Chunk ``c``'s frame (the schedule read at call time, so failover
    re-pointing is honoured), with a produce of the next chunk sent
    ahead so the server builds c+1 while c's bytes are on the wire.
    Called by the stager's worker and by its synchronous fallback."""
    desc = self._schedule[c]
    nxt = c + 1
    if nxt < len(self._schedule) and not self._stager.has_frame(nxt):
      nd = self._schedule[nxt]
      try:
        fut = self._dist_client.async_request_server(
            nd['rank'], 'block_produce', nd['pid'], nd['epoch'],
            nd['start'], nd['k'])
        fut.add_done_callback(lambda f: f.exception())  # swallowed
      except Exception:  # noqa: BLE001 - producing ahead is optional
        pass
    t0 = time.perf_counter()
    with spans.span('remote.block_fetch', chunk=int(c),
                    rank=int(desc['rank']), start=int(desc['start'])):
      frame = with_backpressure(
          lambda: self._dist_client.request_server(
              desc['rank'], 'block_fetch', desc['pid'], desc['epoch'],
              desc['start'], desc['k'], idempotent=True),
          describe=f'block_fetch chunk {c} rank {desc["rank"]}',
          budget_s=self._bp_budget, tenant=self._tenant)
    metrics.observe('remote.block_fetch_ms',
                    (time.perf_counter() - t0) * 1e3)
    nbytes = sum(int(np.asarray(v).nbytes) for v in frame.values())
    metrics.inc('remote.blocks')
    metrics.inc('remote.block_bytes', nbytes)
    metrics.observe('remote.block_mb_per_chunk', nbytes / 1e6)
    return frame

  # ----------------------------------------------------- frame payload

  def _train_arrays(self, frame: dict) -> Dict[str, np.ndarray]:
    """The frame's training payload, ``[k, ...]`` arrays in a fixed key
    order: features, edge lists and masks, labels, the seed count and
    the overflow flag of every step."""
    if self._input_type is not None:
      t_in = self._input_type
      out = {}
      for prefix in ('x', 'row', 'col', 'edge_mask'):
        for kk in sorted(kk for kk in frame if kk.startswith(prefix + '.')):
          out[kk] = np.asarray(frame[kk])
      out[f'y.{t_in}'] = np.asarray(frame[f'y.{t_in}'])
      nsn = np.asarray(frame[f'num_sampled_nodes.{t_in}'])
    else:
      out = {kk: np.asarray(frame[kk])
             for kk in ('x', 'row', 'col', 'edge_mask', 'y')}
      nsn = np.asarray(frame['num_sampled_nodes'])
    for kk, v in out.items():
      if v.dtype == np.uint16:    # bf16 bits: carried as int16 here
        out[kk] = v.view(np.int16)
    k = nsn.shape[0]
    out['#nseed'] = nsn[:, :1].astype(np.int32)
    out['#ovf'] = np.asarray(frame.get('#META.overflow',
                                       np.zeros((k,), bool))
                             ).astype(bool).reshape(k, 1)
    return out

  def _slot_bytes(self, frame: dict) -> int:
    """The slots' size: one full chunk of this stream's frames."""
    self._ensure_layout(frame)
    return self._layout.nbytes

  def _ensure_layout(self, frame: dict):
    if self._layout is None:
      self._layout = _Layout(self._train_arrays(frame), self.chunk_size)

  def _pack(self, frame: dict, buf: torch.Tensor) -> dict:
    """Copy the frame's training payload into a slot's buffer; keep its
    ack keys."""
    self._ensure_layout(frame)
    self._layout.pack(self._train_arrays(frame), buf)
    return self._ack_keys(frame)

  def _ack_keys(self, frame: dict) -> dict:
    keep = ('batch', f'batch.{self._input_type}', '#META.batch_size')
    return {kk: np.asarray(frame[kk]) for kk in keep if kk in frame}

  # ----------------------------------------------------------- failover

  def _require_failover(self):
    # the servers' epoch permutation is epoch-addressed, so a survivor's
    # replay producer draws the same order also with shuffle=True
    if not self._failover_enabled:
      raise RuntimeError(
          'sampling server died and failover is disabled '
          '(RemoteDistSamplingWorkerOptions.failover=False)')

  def _replay_pid(self, survivor: int, stream_i: int) -> int:
    """A block producer for stream ``stream_i``'s share on the survivor:
    the same share and folded config, so its blocks are the dead
    server's bytes. The worker_key makes the create retry-safe."""
    key = (survivor, stream_i)
    pid = self._replay_pids.get(key)
    if pid is not None:
      return pid
    st = self._streams[stream_i]
    pid = with_backpressure(
        lambda: self._dist_client.request_server(
            survivor, 'create_block_producer', st['seeds'], st['cfg'],
            self._wire_dtype,
            worker_key=f'{self._worker_key}/bfo/s{stream_i}/r{survivor}',
            idempotent=True, **self._tenant_kwargs()),
        describe=f'replay producer stream {stream_i} rank {survivor}',
        budget_s=self._bp_budget, tenant=self._tenant)
    self._replay_pids[key] = pid
    return pid

  # ------------------------------------------------- tenancy / elasticity

  def _tenant_kwargs(self) -> dict:
    """``create_block_producer`` keywords registering the streams under
    this trainer's tenant; empty when no tenant is configured."""
    if self._tenant is None:
      return {}
    return dict(tenant=self._tenant, priority=self._tenant_priority,
                weight=self._tenant_weight)

  def set_block_ranks(self, ranks: List[int]):
    """Elastic resize: restrict block production to ``ranks``. Mid-epoch,
    pending not-yet-staged chunks whose home rank left the active set are
    re-pointed at replay producers on active ranks (the same bytes)."""
    live = [r for r in dict.fromkeys(ranks) if r not in self._dead_ranks]
    unknown = [r for r in live if r not in self.server_ranks]
    if unknown:
      raise ValueError(f'unknown server ranks {unknown}; trainer knows '
                       f'{self.server_ranks}')
    if not live:
      raise ValueError('set_block_ranks needs at least one live rank '
                       f'(dead={self._dead_ranks})')
    self._active_ranks = live
    if not self._schedule:
      return
    moved = 0
    for j in range(self._current_chunk + 1, len(self._schedule)):
      d = self._schedule[j]
      if (d['rank'] in self._active_ranks or
          d['rank'] in self._dead_ranks or self._stager.has_frame(j)):
        continue
      tgt = self._active_ranks[moved % len(self._active_ranks)]
      d['pid'] = self._replay_pid(tgt, d['stream'])
      d['rank'] = tgt
      moved += 1
    if moved:
      metrics.inc('tenant.rebalanced_blocks', moved)

  def set_tenant_weight(self, weight: float):
    """Push a new fair-share weight to every live server, then grow or
    shrink the active producer ranks in proportion to it."""
    if weight <= 0:
      raise ValueError(f'tenant weight must be > 0, got {weight}')
    if self._tenant is not None:
      for r in self.server_ranks:
        if r in self._dead_ranks:
          continue
        try:
          self._dist_client.request_server(
              r, 'update_tenant', self._tenant, weight=float(weight),
              idempotent=True)
        except _DEAD_EXCS:
          pass   # the heartbeat declares it; the re-point happens there
    self._tenant_weight = float(weight)
    live = [r for r in self.server_ranks if r not in self._dead_ranks]
    frac = min(1.0, float(weight) / max(self._base_weight, 1e-9))
    target = max(1, int(np.ceil(frac * len(live))))
    self.set_block_ranks(live[:target])

  def _handle_dead_rank(self, rank: int, cause: str, ci: int):
    """Declare ``rank`` dead and re-point its pending (unfetched) blocks
    at survivors; frames already on the client are kept, so a killed
    server costs at most its in-flight block. Idempotent per rank."""
    if rank in self._dead_ranks:
      return
    pending = [j for j in range(ci, len(self._schedule))
               if self._schedule[j]['rank'] == rank and
               not self._stager.has_frame(j)]
    if pending:
      # feasibility first: an epoch that cannot fail over does not mark
      # the rank dead
      self._require_failover()
    self._dead_ranks[rank] = str(cause)
    self._heartbeat.mark_dead(rank, cause)
    if not pending:
      return
    survivors = [r for r in self.server_ranks if r not in self._dead_ranks]
    if not survivors:
      raise RuntimeError(
          f'all sampling servers dead (last: rank {rank}: {cause}) — '
          'cannot complete the epoch')
    fo_span = spans.begin('loader.failover', rank=rank,
                          cause=str(cause)[:200], blocks=len(pending),
                          detected_chunk=int(ci),
                          survivors=list(survivors))
    try:
      for n, j in enumerate(pending):
        surv = survivors[n % len(survivors)]
        d = self._schedule[j]
        d['pid'] = self._replay_pid(surv, d['stream'])
        d['rank'] = surv
    except BaseException as e:
      fo_span.attrs['error'] = f'{type(e).__name__}: {e}'
      raise
    finally:
      spans.end(fo_span)
    trace.counter_inc('resilience.failover')
    metrics.inc('remote.failover_blocks', len(pending))
    logger.warning('sampling server rank %d dead (%s): re-replaying %d '
                   'pending blocks on survivors %s', rank, cause,
                   len(pending), survivors)
    self._stager.fail_pending(
        pending, ConnectionError(f'rank {rank} dead: {cause}'))

  def _poll_liveness(self, ci: int):
    for rank, cause in self._heartbeat.dead_ranks().items():
      if rank not in self._dead_ranks:
        self._handle_dead_rank(rank, cause, ci)

  def _take_with_failover(self, ci: int) -> _Slab:
    """take() with dead-server recovery: each failure declares the
    current owner dead and re-points the chunk at a survivor; bounded by
    the server count."""
    for _ in range(len(self.server_ranks) + 1):
      try:
        return self._stager.take(ci)
      except _DEAD_EXCS as e:
        self._handle_dead_rank(self._schedule[ci]['rank'], repr(e), ci)
    raise RuntimeError(f'chunk {ci}: no server could deliver its '
                       f'block (dead={self._dead_ranks})')

  # ----------------------------------------------------------------- epoch

  def run_epoch(self, state, max_steps: Optional[int] = None,
                start_step: int = 0, resume_overflow: bool = False):
    """One chunk-staged remote epoch. Returns ``(state, losses, accs)``,
    ``[steps]`` device tensors: read them once, after the epoch. The
    model's parameters are updated in place. ``start_step`` (a block
    boundary) resumes this epoch mid-flight: go through
    ``recovery.ChunkCheckpointer.resume_epoch``."""
    if not self._hb_started:
      self._heartbeat.start()
      self._hb_started = True
    epoch_no = self._epochs
    full_steps = len(self)
    steps = full_steps
    truncated = max_steps is not None and max_steps < steps
    if truncated:
      steps = max_steps
    if start_step:
      if start_step not in set(self._block_boundaries()):
        raise ValueError(f'start_step={start_step} is not a block '
                         f'boundary (chunk_size={self.chunk_size}): resume '
                         'only at the boundaries checkpoints are taken at')
      if not 0 <= start_step < steps:
        raise ValueError(f'start_step={start_step} outside this '
                         f"epoch's {steps} steps")
    extra = {'chunk_size': self.chunk_size, 'truncated': truncated}
    if steps <= 0:
      empty = torch.zeros(0, dtype=torch.float32, device=self.device)
      with epoch_records(self._NAME, epoch_no, self._flight_config(),
                         extra) as rec:
        rec['completed'] = True
      return state, empty, empty
    extra['start_step'] = start_step
    # read when the record closes: the epoch's dead ranks
    extra['dead_ranks'] = dead = {}
    with epoch_records(self._NAME, epoch_no, self._flight_config(),
                       extra) as rec:
      self._steps_dispatched = start_step
      try:
        # GLT_STRICT's region (utils.strict): the epoch body
        with strict.strict_guards():
          state, losses, accs, ovf = self._run_epoch_body(
              state, steps, full_steps, start_step=start_step,
              resume_overflow=resume_overflow)
        rec['completed'] = True
      finally:
        rec['steps'] = steps if rec['completed'] else self._steps_dispatched
        dead.update({str(r): c for r, c in self._dead_ranks.items()})
    self.last_overflow = ovf
    return state, losses, accs

  @property
  def capture_ms(self) -> dict:
    """Host ms each captured chunk length took to capture."""
    return {k: g.capture_ms for k, g in self._graphs.items()}

  def _run_epoch_body(self, state, steps, full_steps, start_step=0,
                      resume_overflow=False):
    epoch = self._epochs
    self._schedule = self._block_schedule(steps, epoch)
    start_idx = 0
    if start_step:
      start_idx = next(i for i, d in enumerate(self._schedule)
                       if d['step0'] == start_step)
    self._current_chunk = start_idx - 1
    self._seen_ids: List[np.ndarray] = []
    self._chunk_log = []
    self.uploads = self.replays = 0
    if self._graphs and \
        _replay_signature(self.model, state.optimizer) != self._signature:
      # the graphs froze another state: warm up again and recapture
      self._graphs, self._warm, self._signature = {}, False, None
    self._stager.begin_epoch(len(self._schedule), start_chunk=start_idx)
    losses, accs = [], []
    record_dispatch('remote_epoch_begin')
    try:
      with self._trainer_stream():
        ovf = torch.full((), bool(resume_overflow), dtype=torch.bool,
                         device=self.device)
        for ci in range(start_idx, len(self._schedule)):
          self._current_chunk = ci   # elastic re-points only chunks > ci
          desc = self._schedule[ci]
          if self.stage_hook is not None:
            self.stage_hook(ci, desc['step0'], desc['k'])
          self._poll_liveness(ci)
          slab = self._take_with_failover(ci)
          rec = self._upload(ci, slab, desc['k'])
          record_dispatch('remote_scan_chunk')
          with spans.span('epoch.chunk', start=desc['step0'], k=desc['k']):
            loss, acc, overflow = self._run_chunk(state, desc['k'])
          rec['events'].append(self._event())
          # the upload's event: the slot is refilled once it completed
          self._stager.ack(ci, rec['events'][1])
          self._ack_frame(rec.pop('meta'))
          ovf = ovf | overflow
          losses.append(loss)
          accs.append(acc)
          state = state._replace(step=state.step + desc['k'])
          self._steps_dispatched = desc['step0'] + desc['k']
          if self.ack_hook is not None:
            self._chunk_carry = dict(state=state, ovf=ovf, losses=losses,
                                     accs=accs, steps=steps,
                                     full_steps=full_steps,
                                     start_step=start_step)
            self.ack_hook(ci, desc['step0'], desc['k'])
    finally:
      self._current_chunk = len(self._schedule)
    if len(losses) > 1:
      record_dispatch('remote_metrics_concat')
    self.last_epoch_seed_ids = (
        np.concatenate(self._seen_ids) if self._seen_ids
        else np.zeros((0,), np.int64))
    self._epochs += 1
    return state, torch.cat(losses), torch.cat(accs), ovf

  def _trainer_stream(self):
    """With ``capture``: the trainer's own stream (where the warm-up ran
    and the graphs are captured), ordered after the caller's work and
    before what the caller does next."""
    if not self.capture:
      return contextlib.nullcontext()
    if self._stream is None:
      self._stream = torch.cuda.Stream(self.device)
    return own_stream(self._stream)

  def _event(self):
    if self.device.type != 'cuda':
      return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  def _upload(self, ci: int, slab: _Slab, k: int) -> dict:
    """Chunk ``ci``'s payload into the static device buffer: one copy of
    the slot's first ``k`` steps, on the trainer's stream, without
    blocking the host. A degraded (synchronous) fetch brings a frame
    instead of a slot: it is packed here into a host buffer first."""
    meta = slab.meta
    if slab.slot is not None:
      src = slab.slot.buf
    else:
      frame = slab.frame
      self._ensure_layout(frame)
      src = torch.empty((self._layout.nbytes,), dtype=torch.uint8)
      meta = self._pack(frame, src)
    lay = self._layout
    if self._dev_buf is None:
      self._dev_buf = torch.zeros((lay.nbytes,), dtype=torch.uint8,
                                  device=self.device)
      self._steps_view = lay.views(self._dev_buf)
    n = k * lay.step_bytes
    start = self._event()
    self._dev_buf[:n].copy_(src[:n], non_blocking=slab.slot is not None)
    copied = self._event()
    self.uploads += 1
    rec = dict(chunk=ci, k=k, bytes=n, fetch_ms=slab.fetch_ms,
               pin_ms=slab.pin_ms, wait_ms=self._stager.wait_ms.get(ci),
               events=[start, copied], meta=meta)
    self._chunk_log.append(rec)
    return rec

  def _batch(self, step: Dict[str, torch.Tensor]) -> dict:
    """One step's batch dict (``models.train``'s) over its views: the
    bf16 wire features upcast to float32."""
    bf16 = self._wire_dtype is not None

    def up(v):
      return v.view(torch.bfloat16).float() if bf16 else v

    nseed = step['#nseed'][0]
    if self._input_type is not None:
      t_in = self._input_type
      x = {kk[2:]: up(v) for kk, v in step.items() if kk.startswith('x.')}
      ei, em = {}, {}
      for kk, v in step.items():
        if kk.startswith('row.'):
          name = kk[4:]
          ei[to_edge_type(name)] = torch.stack([v, step['col.' + name]])
          em[to_edge_type(name)] = step['edge_mask.' + name]
      return dict(x=x, edge_index=ei, edge_mask=em, y=step[f'y.{t_in}'],
                  num_seed_nodes=nseed)
    return dict(x=up(step['x']),
                edge_index=torch.stack([step['row'], step['col']]),
                edge_mask=step['edge_mask'], y=step['y'],
                num_seed_nodes=nseed)

  def _chunk(self, state, k: int):
    """The chunk's k train steps over the static buffer's views, eagerly:
    what a capture records. Returns ``([k] losses, [k] accs, overflow)``."""
    ovf = torch.zeros((), dtype=torch.bool, device=self.device)
    losses, accs = [], []
    for j in range(k):
      step = self._steps_view[j]
      _, loss, acc = self._train_step(state, self._batch(step))
      ovf = ovf | step['#ovf'][0]
      losses.append(loss)
      accs.append(acc)
    return torch.stack(losses), torch.stack(accs), ovf

  def _run_chunk(self, state, k: int):
    """One chunk: eagerly (the CPU, ``capture=False``, the warm-up), or
    as a replay of its length's graph, captured at first use."""
    reg = programs.default_program_registry()
    if not self.capture or not self._warm:
      reg.on_dispatch('remote_scan_chunk')
      out = self._chunk(state, k)
      if self.capture:
        self._warm = True
        self._signature = _replay_signature(self.model, state.optimizer)
      return out
    g = self._graphs.get(k)
    if g is None:
      g = self._graphs[k] = self._capture(state, k)
      sig = capture_signature(k, {'payload': self._dev_buf[
          :k * self._layout.step_bytes]}, self.model, state.optimizer)
      # the capture is the port's compile (its dispatch is the replay)
      reg.on_compile('remote_scan_chunk', sig, g.capture_ms / 1e3)
    else:
      reg.on_dispatch('remote_scan_chunk')
    g.graph.replay()
    self.replays += 1
    ops.add_launch_counts(g.launches)
    return g.losses.clone(), g.accs.clone(), g.ovf.clone()

  def _capture(self, state, k: int) -> _ChunkGraph:
    """Capture a ``k``-step chunk over the static buffer
    (``loader.scan_epoch.capture_chunk``)."""
    graph, out, launches, ms = capture_chunk(
        self._stream, lambda: self._chunk(state, k))
    return _ChunkGraph(graph, *out, None, launches, ms)

  def drop_graphs(self):
    """Forget the captured chunks, their static buffer and the gradients
    their capture allocated in the graphs' memory pool."""
    self._graphs, self._warm, self._signature = {}, False, None
    self._dev_buf = self._steps_view = None
    self.model.zero_grad(set_to_none=True)
    if self.device.type == 'cuda':
      gc.collect()
      torch.cuda.empty_cache()

  def chunk_timings(self) -> list:
    """Per chunk of the last epoch: its steps and uploaded bytes, the
    worker's fetch RPC ms and pinned-copy ms, the dispatch thread's wait
    at ``take``, and on a card the upload's and the chunk's device ms
    (CUDA events; reading them waits for the epoch's end)."""
    out = []
    for rec in self._chunk_log:
      r = {kk: v for kk, v in rec.items() if kk != 'events'}
      start, copied, done = rec['events']
      if done is not None:
        done.synchronize()
        r['upload_ms'] = start.elapsed_time(copied)
        r['device_ms'] = copied.elapsed_time(done)
      else:
        r['upload_ms'] = r['device_ms'] = None
      out.append(r)
    return out

  def _ack_frame(self, keys: dict):
    """Host-side seed ack by chunk: the seed ids this block delivered
    (typed frames: the seed type's ``batch.<t>``)."""
    ids = keys.get('batch')
    if ids is None and self._input_type is not None:
      ids = keys.get(f'batch.{self._input_type}')
    if ids is None:
      return
    ids = np.asarray(ids)
    bs = keys.get('#META.batch_size')
    if bs is not None:
      bs = np.asarray(bs).reshape(-1)
      rows = [ids[j][:int(bs[j])] for j in range(ids.shape[0])]
      ids = np.concatenate(rows) if rows else ids.reshape(-1)
    else:
      ids = ids.reshape(-1)
    self._seen_ids.append(np.asarray(ids, np.int64).reshape(-1))

  # -------------------------------------------------------------- config

  def _flight_config(self) -> dict:
    fans = self._config.num_neighbors
    return dict(trainer=self._NAME, batch_size=self.batch_size,
                chunk_size=self.chunk_size, input_type=self._input_type,
                fanouts=(dict(fans) if isinstance(fans, dict)
                         else list(fans)),
                shuffle=self._shuffle, drop_last=self._drop_last,
                num_classes=self.num_classes, seed=self.seed,
                servers=list(self.server_ranks),
                wire_dtype=self._wire_dtype, tenant=self._tenant,
                tenant_priority=self._tenant_priority,
                tenant_weight=self._tenant_weight,
                active_ranks=list(self._active_ranks))

  # -------------------------------------------------- recovery protocol
  # (recovery.ChunkCheckpointer). The client carries no sampler: the
  # server streams are addressed by (epoch, batch index), so a snapshot
  # needs only the epoch index beyond the train state.

  def _recovery_config(self) -> dict:
    import hashlib
    cfg = self._flight_config()
    # the elastic tenancy state changes mid-run by design
    cfg.pop('active_ranks', None)
    cfg.pop('tenant_weight', None)
    fans = cfg['fanouts']
    if isinstance(fans, dict):
      cfg['fanouts'] = {str(et): v for et, v in fans.items()}
    cfg.update(
        collect_features=self._config.collect_features,
        seeds_sha=hashlib.sha1(
            np.ascontiguousarray(
                self.input_seeds.astype(np.int64)).tobytes())
        .hexdigest()[:16])
    return cfg

  def _recovery_capture(self, carry):
    del carry
    return {}, {}

  def _recovery_load(self, meta, arrays):
    del arrays
    self._epochs = int(meta['epoch'])

  def _recovery_advance(self, meta):
    self._epochs = int(meta['epoch']) + 1

  # ------------------------------------------------------------ teardown

  def shutdown(self):
    """Stop the stager and the heartbeat and destroy the server-side block
    producers (dead ranks skipped; destroys are idempotent)."""
    self._stager.close()
    self._heartbeat.stop()
    targets = [(st['rank'], st['pid']) for st in self._streams]
    targets += [(rank, pid)
                for (rank, _), pid in self._replay_pids.items()]
    for rank, pid in targets:
      if rank in self._dead_ranks:
        continue
      try:
        self._dist_client.request_server(rank, 'destroy_block_producer',
                                         pid)
      except (RuntimeError, ConnectionError, OSError):
        pass
