"""TieredDistScanTrainer: device oversubscription through the shard
exchange.

Counterpart of ``graphlearn_tpu/storage/dist_scan.py``, homogeneous and typed.
``loader.DistScanTrainer`` keeps every shard's whole feature partition on
the device, since any shard may ask it for any of its rows. This trainer
runs the same epoch over a ``storage.TieredDistFeature`` of which the
device holds only each partition's hot prefix (positions ``[0, H)`` of its
sorted table, ``dist_scan_tables``) and a static slab of staged rows;
the rest stays in the store's disk tiers. Losses and parameters equal
the all-device trainer's:

* **The plan prologue.** Before the first chunk the distributed sampler
  is replayed on ids only over every step, eagerly, on the trainer's
  stream, under the chunks' own keys (``ops.dist_step_keys`` from
  ``count0``). The ``[steps, P, node_cap]`` node ids come to the host in
  one copy (the epoch's one host sync) and ``planner.plan_exchange``
  turns them into the exact per-chunk miss-exchange program: which
  positions of each shard's table the shards will ask it for, beyond
  the replicated hot cache and the hot prefix.
* **Chunk-boundary staging.** While chunk ``c`` trains, a
  ``DistChunkStager`` worker gathers chunk ``c+1``'s planned positions
  from the tiers into a pinned ``[P, cap]`` / ``[P, cap, F]`` ring slab
  (pow2 ``cap``: the chunk's largest per-shard count). At the boundary
  the dispatch thread copies it into the trainer's static device slab on
  the trainer's stream without blocking the host, records an event after
  the copy and acks the chunk with it: the worker refills that ring slot
  only once the event has completed.
* **The slab-backed owner lookup.** The chunk's feature lookup is
  ``DistFeature._lookup`` over the hot prefix and the static slab: an
  owner resolves a request's position as before and takes its row from
  the hot prefix (K1) or the slab. Under the exact plan every staged
  row equals the all-device row.
* **Slab shapes under CUDA graphs.** JAX compiles one program per
  (chunk length, pow2 slab cap); here the static slab is one ``[P,
  cap]`` buffer pair at the plan's largest cap (INT32_MAX past a chunk's
  own), and one graph per chunk length. An epoch whose plan needs a
  larger cap reallocates the slab and drops the graphs in its prologue.
* **Degradation, never corruption.** A failed or slow worker degrades to
  a synchronous gather of the same planned positions
  (``storage.prefetch_miss``).

* **Typed loaders.** ``{ntype: TieredDistFeature}`` stores: one plan,
  stager and static slab per sampled, featured node type, each type's
  lookup over its own hot prefix and slab; the prologue's replayed node
  ids of every type come to the host in one copy.

Scope: a one-process mesh (the prologue and the stager read every
shard's rows on one host). Labels stay a full (small) ``DistFeature``. Not
ported: the spans. The stager's worker passes the ``storage.dist_stage``
fault site (``DistChunkStager._stage_fault``). ``config=`` takes a tune
artifact of topology 'tiered_dist' (or a local one), as JAX's: its
``hot_prefix_rows`` is a store-construction knob, so a store built with
another hot prefix is refused. Under ``GLT_STRICT`` the prologue's one
fetch of the replayed node ids is a deliberate sync
(``utils.strict.explicit``).
"""
import time
from typing import Optional

import numpy as np
import torch

from .. import metrics
from .. import ops
from ..loader.scan_epoch import DistScanTrainer
from ..sampler.capacity import CapacityPlanError
from ..utils import strict
from ..utils.faults import fault_point
from . import planner
from .dist import TieredDistFeature
from .staging import INT32_MAX, ChunkStager, _Slot, pow2_slab_cap


class DistChunkStager(ChunkStager):
  """``ChunkStager`` whose plan rows are encoded ``p * n_max + position``
  addresses (``planner.ExchangePlan``) and whose slabs come back in the
  ``[P, cap]`` per-shard layout the chunk's lookup reads. Pad slots carry
  INT32_MAX positions (a binary search never matches them); per-shard
  position lists stay sorted because the encoded plan is."""

  def _stage_fault(self):
    # the distributed stager's own fault site, in the worker only, so
    # take()'s synchronous fallback still gathers cleanly
    fault_point('storage.dist_stage')

  def _ring_cap(self, chunk_rows) -> int:
    """The plan's largest per-shard pow2 count (``ExchangePlan``'s)."""
    store = self.store
    caps = [1]
    for enc in chunk_rows:
      if enc.size:
        per = np.bincount(np.asarray(enc) // store.n_max,
                          minlength=store.num_partitions)
        caps.append(pow2_slab_cap(int(per.max())))
    return max(caps)

  def _new_slot(self, cap: int) -> _Slot:
    # cap rows a shard, flat, so each chunk's [P, cap] view is contiguous
    return _Slot(self.store.num_partitions * cap, self.store.feature_dim,
                 self._row_dtype(), self._pin)

  def _gather_to(self, enc: np.ndarray, alloc):
    """Gather the planned positions of ``enc`` into ``[P, cap]`` ids and
    ``[P, cap, F]`` rows from ``alloc(cap)`` (pads: INT32_MAX, zeros)."""
    store = self.store
    enc = np.asarray(enc, np.int64)
    owners = enc // store.n_max
    pos = enc % store.n_max
    counts = np.bincount(owners, minlength=store.num_partitions)
    ids, rows = alloc(pow2_slab_cap(int(counts.max()) if enc.size else 1))
    ids_np, rows_np = ids.numpy(), rows.numpy()
    ids_np.fill(INT32_MAX)
    rows_np.fill(0)
    for p in range(store.num_partitions):
      kp = int(counts[p])
      if kp:
        m = owners == p
        ids_np[p, :kp] = pos[m].astype(np.int32)
        rows_np[p, :kp] = store.gather_positions(p, pos[m])
    metrics.inc('storage.dist_staged_rows', int(enc.shape[0]))
    return ids, rows

  def _gather_into(self, enc: np.ndarray, slot: _Slot):
    nparts, f = self.store.num_partitions, self.store.feature_dim
    return self._gather_to(enc, lambda cap: (
        slot.ids[:nparts * cap].view(nparts, cap),
        slot.rows[:nparts * cap].view(nparts, cap, f)))

  def _gather(self, enc: np.ndarray):
    """The degraded path's synchronous gather: a fresh slab (pinned on a
    card), the same bytes as the worker's."""
    nparts, f = self.store.num_partitions, self.store.feature_dim
    return self._gather_to(enc, lambda cap: (
        torch.empty((nparts, cap), dtype=torch.int32, pin_memory=self._pin),
        torch.empty((nparts, cap, f), dtype=self._row_dtype(),
                    pin_memory=self._pin)))


class TieredDistScanTrainer(DistScanTrainer):
  """``DistScanTrainer`` over a ``TieredDistFeature`` whose device holds
  only each shard's hot prefix and the staged slab (module docstring); a
  typed loader takes a ``{ntype: TieredDistFeature}`` store dict.

  Args (beyond ``DistScanTrainer``'s):
    max_ahead: staged chunks in flight (2 = double buffer).
    stage_timeout_s: how long a chunk boundary waits for its slab before
      degrading to a synchronous gather.

  After an epoch: ``last_plan`` (its ``planner.ExchangePlan``; typed: a
  ``{ntype: ExchangePlan}`` dict), ``prologue_ms`` and
  :meth:`chunk_timings`.
  """

  _NAME = 'TieredDistScanTrainer'
  _TOPOLOGY = 'tiered_dist'

  def __init__(self, loader, model, num_classes: int,
               chunk_size: Optional[int] = None,
               seed_labels_only: Optional[bool] = None,
               perm_seed: Optional[int] = None, max_ahead: int = 2,
               stage_timeout_s: float = 30.0, config=None,
               capture: Optional[bool] = None):
    sampler = getattr(loader, 'sampler', None)
    store = getattr(sampler, 'dist_feature', None)
    stores = store if isinstance(store, dict) else {None: store}
    for t, st in stores.items():
      what = '' if t is None else f' for ntype {t!r}'
      if not isinstance(st, TieredDistFeature):
        raise CapacityPlanError(
            self._NAME,
            f'the feature store{what} carries no slab capacities (a '
            f'{type(st).__name__}, not a TieredDistFeature)',
            hint='build the store as storage.TieredDistFeature('
                 'hot_prefix_rows >= 1) so the exchange planner can close '
                 'its slab shapes; all-device DistFeature partitions keep '
                 'loader.DistScanTrainer')
      if st.hot_prefix_rows < 1:
        raise CapacityPlanError(
            self._NAME, f'the store{what} declares no hot prefix '
            '(hot_prefix_rows < 1)', hint='the chunk clamps pad positions '
            'into the hot prefix: pass hot_prefix_rows >= 1 at store '
            'construction')
      if st.mesh.group is not None:
        raise ValueError(f'{self._NAME} plans and stages every shard on '
                         'one host: a one-process mesh only')
    if config is not None:
      # hot_prefix_rows is a STORE-construction knob: a tuned value that
      # disagrees with the store handed in is a loud error, not a silent
      # acceptance of untuned capacity (JAX's rule)
      tuned_hot = (config.choices or {}).get('hot_prefix_rows') \
          if hasattr(config, 'choices') else None
      for t, st in stores.items():
        want = (tuned_hot.get(t) if isinstance(tuned_hot, dict)
                else tuned_hot)
        if want is not None and int(want) != int(st.hot_prefix_rows):
          raise ValueError(
              f'{self._NAME}: tune artifact pins hot_prefix_rows='
              f'{int(want)} but the TieredDistFeature store'
              f'{"" if t is None else f" for ntype {t!r}"} was '
              f'built with hot_prefix_rows={int(st.hot_prefix_rows)} '
              '— rebuild the store with the tuned value (the knob is '
              'storage layout, not a trainer kwarg; docs/tuning.md)')
    self._store = store
    self._slab_pos = {}     # the static device slabs, [L, cap] per type
    self._slab_rows = {}
    super().__init__(loader, model, num_classes, chunk_size,
                     seed_labels_only, perm_seed, config=config,
                     capture=capture)
    self._tiered = self._stores()
    self._stagers = {t: DistChunkStager(st, max_ahead=max_ahead,
                                        timeout_s=stage_timeout_s)
                     for t, st in self._tiered.items()}
    self._stager = self._stagers.get(None)
    self.last_plan = None
    self.prologue_ms = None
    self._epoch_span = (0, 0)
    self._chunk_log = []

  def _feature_tables(self, ntype=None):
    """The hot prefix and the static slab (of ``ntype``), read at call
    time (a capture records their addresses)."""
    store = self._store[ntype] if ntype is not None else self._store
    return dict(store.dist_scan_tables(), slab_pos=self._slab_pos[ntype],
                slab_rows=self._slab_rows[ntype])

  # ------------------------------------------------------------ prologue

  def _run_epoch_body(self, state, steps: int, full_steps: int,
                      start_step: int = 0, resume_overflow: bool = False):
    self._epoch_span = (steps, start_step)
    self._chunk_log = []
    return super()._run_epoch_body(state, steps, full_steps, start_step,
                                   resume_overflow)

  def _prologue(self, full_steps: int):
    """The seed matrices, then the epoch's exchange plans: the id-only
    replay of the sampler over its steps, one fetch of the node ids (of
    every featured type), the per-chunk miss sets, the static slabs
    sized for them and the stagers primed at the resume chunk."""
    seed_mat, mask_mat = super()._prologue(full_steps)
    steps, start_step = self._epoch_span
    t0 = time.perf_counter()
    with self._capture_stream():
      rows = self._plan_rows(seed_mat[:steps], mask_mat[:steps])
      if not self.is_hetero:
        rows = {None: rows}
      types = list(self._tiered)
      widths = [rows[t].shape[-1] for t in types]
      # the epoch's one host sync (JAX's explicit device_get)
      with strict.explicit():
        flat = torch.cat([rows[t] for t in types], -1).cpu().numpy()
      del rows
      plans, off = {}, 0
      for t, w in zip(types, widths):
        store = self._tiered[t]
        plans[t] = planner.plan_exchange(
            flat[..., off:off + w].transpose(1, 0, 2), self.chunk_size,
            store.feature_pb, store.feat_ids, store.hot_prefix_rows,
            cache_ids=store.cache_ids)
        off += w
        self._size_slab(t, max(plans[t].slab_caps()))
    self.last_plan = plans if self.is_hetero else plans[None]
    for t, plan in plans.items():
      self._stagers[t].begin_epoch(plan.chunk_rows,
                                   start_chunk=start_step // self.chunk_size)
    self._plans = plans
    self.prologue_ms = (time.perf_counter() - t0) * 1e3
    return seed_mat, mask_mat

  def _plan_rows(self, seed_mat, mask_mat):
    """``[steps, L, node_cap]`` node ids of every step (typed: a ``{ntype:
    ...}`` dict of the featured types), sampled under the chunks' own
    keys."""
    device = seed_mat.device
    steps = seed_mat.shape[0]
    base_key = torch.as_tensor(self._sampler._key).to(device)
    counter = torch.full((), self._sampler._call_count + 1,
                         dtype=torch.int64, device=device)
    keys = ops.dist_step_keys(base_key, counter, steps, self._nparts,
                              self._n_hops)
    mesh = self.mesh
    nodes = [self._sample(mesh.local_rows(seed_mat[g]),
                          mesh.local_rows(mask_mat[g]),
                          mesh.local_rows(keys[g]))['node']
             for g in range(steps)]
    if not self.is_hetero:
      return torch.stack(nodes)
    return {t: torch.stack([n[t] for n in nodes]) for t in self._tiered}

  def _size_slab(self, ntype, cap: int):
    """Hold a static slab of at least ``cap`` positions a shard; a larger
    one is a new allocation, so the graphs over the old one go."""
    old = self._slab_pos.get(ntype)
    if old is not None and old.shape[1] >= cap:
      return
    store, mesh = self._tiered[ntype], self.mesh
    self._graphs = {}
    self._slab_pos[ntype] = torch.full((mesh.num_local, cap), INT32_MAX,
                                       dtype=torch.int32, device=mesh.device)
    self._slab_rows[ntype] = torch.zeros(
        (mesh.num_local, cap, store.feature_dim),
        dtype=store.storage_dtype, device=mesh.device)

  @property
  def slab_bytes(self) -> int:
    return sum(t.numel() * t.element_size()
               for d in (self._slab_pos, self._slab_rows)
               for t in d.values())

  # --------------------------------------------------------------- chunk

  def _capture_buffers(self, k: int):
    out = super()._capture_buffers(k)
    for t in self._tiered:
      name = '' if t is None else f'.{t}'
      out += [(f'slab_pos{name}', self._slab_pos[t]),
              (f'slab_rows{name}', self._slab_rows[t])]
    return out

  def _chunk_args(self, seed_mat, mask_mat, base_key, count: int,
                  start: int, k: int) -> dict:
    args = super()._chunk_args(seed_mat, mask_mat, base_key, count, start,
                               k)
    for t in self._tiered:
      self._load_slab(t, start // self.chunk_size)
    return args

  def _event(self):
    if self._device.type != 'cuda':
      return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  def _load_slab(self, ntype, c: int):
    """Chunk ``c``'s slab (of ``ntype``) into the static device slab, on
    the current stream (the trainer's), without blocking the host."""
    ids, rows = self._stagers[ntype].take(c)
    cap = ids.shape[1]
    pos, dst = self._slab_pos[ntype], self._slab_rows[ntype]
    start = self._event()
    pos[:, :cap].copy_(ids, non_blocking=True)
    if cap < pos.shape[1]:
      pos[:, cap:].fill_(INT32_MAX)
    dst[:, :cap].copy_(rows, non_blocking=True)
    copied = self._event()
    n = int(self._plans[ntype].chunk_rows[c].shape[0])
    rec = dict(chunk=c, rows=n, cap=int(cap),
               slab_bytes=rows.numel() * rows.element_size() + ids.numel() * 4,
               events=[start, copied])
    if ntype is not None:
      rec['ntype'] = ntype
    self._chunk_log.append(rec)

  def _chunk_enqueued(self, c: int):
    for rec in self._chunk_log[-len(self._tiered):]:
      rec['events'].append(self._event())
      # the ring slot is refilled only once the slab's copy has completed
      self._stagers[rec.get('ntype')].ack(c, rec['events'][1])

  def chunk_timings(self) -> list:
    """Per chunk (and per node type on a typed loader) of the last epoch:
    planned rows, slab cap and bytes, the worker's stage ms, the dispatch
    thread's wait at ``take`` (ms) and, on a card, the slab's
    host-to-device copy and the chunk's device ms (CUDA events; reading
    them waits for the epoch's end)."""
    out = []
    for rec in self._chunk_log:
      c = rec['chunk']
      stager = self._stagers[rec.get('ntype')]
      r = {k: v for k, v in rec.items() if k != 'events'}
      r['stage_ms'] = stager.stage_ms.get(c)
      r['wait_ms'] = stager.wait_ms.get(c)
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
    if self.is_hetero:
      cfg.update(hot_prefix_rows={t: s.hot_prefix_rows
                                  for t, s in self._tiered.items()},
                 n_max={t: s.n_max for t, s in self._tiered.items()})
    else:
      cfg.update(hot_prefix_rows=self._store.hot_prefix_rows,
                 n_max=self._store.n_max)
    return cfg

  def _recovery_capture(self, carry):
    """``DistScanTrainer``'s capture plus the staging rings' watermarks
    (diagnostic: a resume plans and stages again)."""
    meta, dev = super()._recovery_capture(carry)
    meta['staging'] = (
        {t: st.watermarks() for t, st in self._stagers.items()}
        if self.is_hetero else self._stager.watermarks())
    return meta, dev

  def close(self):
    """Stop the staging worker threads."""
    for stager in self._stagers.values():
      stager.close()
