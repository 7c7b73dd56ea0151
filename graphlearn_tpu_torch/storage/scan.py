"""TieredScanTrainer: the scanned epoch over an out-of-core feature store.

Counterpart of ``graphlearn_tpu/storage/scan.py``. ``loader.ScanTrainer``
needs the whole ``[N, F]`` table on the device; this trainer runs the
same epoch of K-step chunks over a ``storage.TieredFeature`` whose table
spans the device, host RAM and disk, with losses and parameters
bit-identical to the all-device trainer's:

* **The plan prologue.** Before the first chunk the sampler is replayed
  on ids only over every step of the epoch, eagerly, on the trainer's
  stream: the same per-step hop keys the chunks derive (``ops.step_keys``
  from ``count0``), so the draws are the chunks' own. The ``[steps,
  node_cap]`` storage-row matrix comes to the host in one copy (the
  epoch's one host sync; no step makes one) and
  ``planner.plan_from_rows`` turns it into per-chunk sorted miss sets.
  The replay advances no counter and reseeds nothing: the sampler's
  counter moves once per epoch, by the steps taken, as in
  ``ScanTrainer``; it shares the sampler's scratch with the chunks,
  ordered before them on one stream.
* **Chunk-boundary staging.** While chunk ``c`` trains, the staging
  worker (``storage/staging.py``) gathers chunk ``c+1``'s warm and disk
  rows into a pinned ring slab. At the boundary the dispatch thread
  copies the slab into the trainer's static device slab without blocking
  the host, records an event after the copy, enqueues the chunk and acks
  it with that event: the worker refills the slot only once the copy has
  completed.
* **The chunk's gather** (:func:`tiered_gather`): the hot-prefix take is
  one launch of the row-gather kernel (``ops.gather_rows_hbm``), the slab
  part a ``torch.searchsorted`` of the slab's sorted ids and two
  ``where``s. Every non-hot row a chunk touches is in its slab (the plan
  is exact), so each step's ``x`` equals the all-device gather's bytes.
* **Slab shapes under CUDA graphs.** JAX compiles one program per (chunk
  length, pow2 slab cap). Here the static slab is one buffer pair at the
  plan's largest pow2 cap (ids ``[cap]`` int32, INT32_MAX past the
  chunk's own cap, and rows ``[cap, F]``), and there is one captured
  graph per chunk length, as in ``ScanTrainer``. Pad ids never match, so
  the bytes are JAX's. An epoch whose plan needs a larger cap
  reallocates the slab and drops the graphs in its prologue, before any
  chunk reads the slab; the chunks are then captured again.
* **Degradation, never corruption.** A failed or slow staging worker
  degrades to a synchronous gather of the same planned rows
  (``storage.prefetch_miss``); the epoch is bit-identical.

Sampling runs twice per epoch (once id-only in the plan, once in the
chunks): the price of an exact plan. Flight records, spans and the
dispatch / capture counts are ``ScanTrainer``'s (the slab is part of a
capture's signature). ``config=`` (a tune artifact) is
``ScanTrainer``'s. Under ``GLT_STRICT`` the epoch body is the guarded
region, as in JAX; the prologue's one fetch of the planned rows is a
deliberate sync (``utils.strict.explicit``, JAX's explicit
``device_get``).
"""
import time
from typing import Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..loader.node_loader import NodeLoader
from ..loader.scan_epoch import ScanTrainer
from ..ops.gather import gather_rows_hbm
from ..utils import strict
from . import planner
from .staging import INT32_MAX, ChunkStager
from .tiered import TieredFeature


def tiered_gather(hot, slab_ids, slab, id2i, node):
  """Feature rows of a node-id buffer from the hot prefix ``hot [H, F]``
  or the chunk's staged slab (``slab_ids [cap]`` sorted storage rows,
  INT32_MAX pads; ``slab [cap, F]``). Clamps as ``ops.collate_batch``
  does (pad slots -> node id 0), so a tiered batch equals the
  all-device gather; a row in neither (impossible under an exact plan)
  reads as zeros."""
  safe = torch.clamp(node, min=0)
  ridx = id2i[safe.long()] if id2i is not None else safe
  hot_rows = gather_rows_hbm(hot, ridx)
  r32 = ridx.to(torch.int32)
  pos = torch.searchsorted(slab_ids, r32).clamp_(0, slab_ids.shape[0] - 1)
  in_slab = slab_ids[pos] == r32
  return torch.where((ridx < hot.shape[0])[:, None], hot_rows,
                     torch.where(in_slab[:, None], slab[pos], 0))


class TieredScanTrainer(ScanTrainer):
  """``ScanTrainer`` over a ``TieredFeature`` (device hot prefix, host
  warm tier, disk cold tier), with the epoch's prefetch plan made in the
  prologue and chunk-boundary staging (module docstring).

  Args (beyond ScanTrainer's):
    max_ahead: staged chunks in flight (2 = double buffer).
    stage_timeout_s: how long a chunk boundary waits for its slab before
      degrading to a synchronous read.

  After an epoch: ``last_plan`` (its ``planner.EpochPlan``),
  ``prologue_ms`` (replay, fetch and plan, host ms) and
  :meth:`chunk_timings`.
  """

  _NAME = 'TieredScanTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               chunk_size: Optional[int] = None,
               seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None, max_ahead: int = 2,
               stage_timeout_s: float = 30.0, config=None,
               capture: Optional[bool] = None):
    store = loader.data.node_features
    if not isinstance(store, TieredFeature):
      raise ValueError(
          f'{self._NAME} drives a storage.TieredFeature store, got '
          f'{type(store).__name__}; use loader.ScanTrainer for all-device '
          'Feature tables')
    self._store = store
    # config= takes a tune artifact: fingerprint-validated in
    # ScanTrainer.__init__, it supplies the tuned chunk K
    super().__init__(loader, model, num_classes, chunk_size,
                     seed_labels_only, perm_seed, config=config,
                     capture=capture)
    self._stager = ChunkStager(store, max_ahead=max_ahead,
                               timeout_s=stage_timeout_s)
    self.last_plan = None      # EpochPlan of the most recent epoch
    self.prologue_ms = None
    self._slab_ids = None      # the static device slab
    self._slab_rows = None
    self._epoch_span = (0, 0)  # (steps, start_step) of the running epoch
    self._chunk_log = []       # per chunk of the epoch: sizes and events

  # ------------------------------------------------------ trainer seams

  def _resolve_feature_tables(self, loader):
    hot, id2i = self._store.scan_tables()
    dev = torch.device(loader.device)
    if hot.device.type != dev.type or \
        (hot.device.index or 0) != (dev.index or 0):
      raise ValueError(f'the store\'s hot prefix is on {hot.device} and '
                       f'the loader on {loader.device}')
    return hot, id2i

  def _make_sample_collate_body(self):
    """The sample+collate body with the tiered gather: it reads the
    static slab the trainer holds at call time (a capture records its
    addresses)."""
    sampler, label_cap = self._sampler, self._label_cap
    hot, id2i, labels = self._feats, self._id2i, self._labels

    def _sample_collate(seeds, smask, hop_keys):
      res = sampler._sample(seeds, smask, hop_keys=hop_keys)
      col = ops.collate_batch(res['node'], res['num_nodes'], res['row'],
                              res['col'], None, None, labels, None, None,
                              label_cap=label_cap)
      x = tiered_gather(hot, self._slab_ids, self._slab_rows, id2i,
                        res['node'])
      batch = dict(x=x, edge_index=col['edge_index'],
                   edge_mask=res['edge_mask'], y=col['y'],
                   num_seed_nodes=res['num_sampled_nodes'][0])
      return batch, res['overflow']

    return _sample_collate

  def _run_epoch_body(self, state, steps: int, full_steps: int,
                      start_step: int = 0, resume_overflow: bool = False):
    self._epoch_span = (steps, start_step)
    self._chunk_log = []
    return super()._run_epoch_body(state, steps, full_steps, start_step,
                                   resume_overflow)

  def _prologue(self, full_steps: int):
    """The seed matrix, then the epoch's plan: the id-only sampler replay
    over its steps, one fetch of the storage rows, the per-chunk miss
    sets, the static slab sized for them and the stager primed."""
    seed_mat, mask_mat = super()._prologue(full_steps)
    steps, start_step = self._epoch_span
    t0 = time.perf_counter()
    with self._capture_stream():   # the trainer's stream, with capture
      rows_mat = self._plan_rows(seed_mat[:steps], mask_mat[:steps])
      rows_host = self._fetch_plan_rows(rows_mat)
      del rows_mat
      plan = planner.plan_from_rows(rows_host, self.chunk_size,
                                    self._store.hot_rows,
                                    self._store.warm_rows)
      self._size_slab(max(plan.slab_caps()))
    self.last_plan = plan
    self._stager.begin_epoch(plan.chunk_rows,
                             start_chunk=start_step // self.chunk_size)
    self.prologue_ms = (time.perf_counter() - t0) * 1e3
    return seed_mat, mask_mat

  def _plan_rows(self, seed_mat, mask_mat):
    """``[steps, node_cap]`` int32 storage rows of every step's node
    buffer, sampled under the chunks' own hop keys."""
    device = seed_mat.device
    steps = seed_mat.shape[0]
    base_key = trandom.to_device(self._sampler._key, device)
    counter = torch.full((), self._sampler._call_count + 1,
                         dtype=torch.int64, device=device)
    keys = ops.step_keys(base_key, counter, steps, self._n_hops)
    rows = []
    for g in range(steps):
      res = self._sampler._sample(seed_mat[g], mask_mat[g],
                                  hop_keys=keys[g])
      safe = torch.clamp(res['node'], min=0)
      ridx = self._id2i[safe.long()] if self._id2i is not None else safe
      rows.append(ridx.to(torch.int32))
    return torch.stack(rows)

  def _fetch_plan_rows(self, rows_mat) -> np.ndarray:
    """The epoch's one host sync: the planned rows to the host."""
    with strict.explicit():
      return rows_mat.cpu().numpy()

  def _size_slab(self, cap: int):
    """Hold a static slab of at least ``cap`` rows; a larger one is a new
    allocation, so the graphs captured over the old one are dropped."""
    if self._slab_ids is not None and self._slab_ids.shape[0] >= cap:
      return
    device = self.loader.device
    self._graphs = {}
    self._slab_ids = torch.full((cap,), INT32_MAX, dtype=torch.int32,
                                device=device)
    self._slab_rows = torch.zeros((cap, self._feats.shape[1]),
                                  dtype=self._feats.dtype, device=device)

  @property
  def slab_bytes(self) -> int:
    """Device bytes of the static slab."""
    if self._slab_ids is None:
      return 0
    return sum(t.numel() * t.element_size()
               for t in (self._slab_ids, self._slab_rows))

  @property
  def ring_bytes(self) -> int:
    """Host bytes (pinned on a card) of the staging ring."""
    return self._stager.ring_bytes

  def _chunk_args(self, seed_mat, mask_mat, base_key, count: int,
                  start: int, k: int) -> dict:
    args = super()._chunk_args(seed_mat, mask_mat, base_key, count, start,
                               k)
    self._load_slab(start // self.chunk_size)
    return args

  def _capture_buffers(self, k: int):
    return super()._capture_buffers(k) + [('slab_ids', self._slab_ids),
                                          ('slab_rows', self._slab_rows)]

  def _event(self):
    if self.loader.device.type != 'cuda':
      return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  def _load_slab(self, c: int):
    """Chunk ``c``'s slab into the static device slab, on the current
    stream (the trainer's), without blocking the host."""
    ids, rows = self._stager.take(c)
    n = int(self.last_plan.chunk_rows[c].shape[0])
    cap = ids.shape[0]
    start = self._event()
    self._slab_ids[:cap].copy_(ids, non_blocking=True)
    if cap < self._slab_ids.shape[0]:
      self._slab_ids[cap:].fill_(INT32_MAX)
    if n:
      self._slab_rows[:n].copy_(rows[:n], non_blocking=True)
    copied = self._event()
    warm_edge = self._store.hot_rows + self._store.warm_rows
    self._chunk_log.append(dict(
        chunk=c, rows=n, disk_rows=int(np.sum(
            self.last_plan.chunk_rows[c] >= warm_edge)),
        slab_bytes=n * rows.shape[1] * rows.element_size() + cap * 4,
        events=[start, copied]))

  def _chunk_enqueued(self, c: int):
    rec = self._chunk_log[-1]
    rec['events'].append(self._event())
    # the slot is refilled only once the slab's copy has completed
    self._stager.ack(c, rec['events'][1])

  def chunk_timings(self) -> list:
    """Per chunk of the last epoch: planned and disk rows, slab bytes,
    the worker's stage ms, the dispatch thread's wait at ``take`` (ms)
    and, on a card, the slab's host-to-device copy and the chunk's device
    ms (CUDA events; reading them waits for the epoch's end)."""
    out = []
    for rec in self._chunk_log:
      c = rec['chunk']
      r = {k: v for k, v in rec.items() if k != 'events'}
      r['stage_ms'] = self._stager.stage_ms.get(c)
      r['wait_ms'] = self._stager.wait_ms.get(c)
      start, copied, done = rec['events']
      if done is not None:
        done.synchronize()
        r['copy_ms'] = start.elapsed_time(copied)
        r['device_ms'] = copied.elapsed_time(done)
      else:
        r['copy_ms'] = r['device_ms'] = None
      out.append(r)
    return out

  # ------------------------------------------------- recovery protocol

  def _flight_config(self) -> dict:
    cfg = super()._flight_config()
    cfg.update(hot_rows=self._store.hot_rows,
               warm_rows=self._store.warm_rows,
               disk_rows=self._store.disk_rows)
    return cfg

  def _recovery_capture(self, carry):
    """ScanTrainer's capture plus the staging ring's watermarks
    (diagnostic: a resume plans and stages again)."""
    meta, dev = super()._recovery_capture(carry)
    meta['staging'] = self._stager.watermarks()
    return meta, dev

  def close(self):
    """Stop the staging worker thread."""
    self._stager.close()


__all__ = ['TieredScanTrainer', 'tiered_gather', 'INT32_MAX']
