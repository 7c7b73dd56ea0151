"""Server-side K-batch block production for the chunk-staged remote scan.

Counterpart of ``graphlearn_tpu/distributed/block_producer.py``. The
per-batch server-client path streams one ``SampleMessage`` per RPC
poll; the chunk-staged path (``distributed/remote_scan.py``) moves the
unit of exchange to the K-batch block: the server replays the same
counter-addressed sampler stream the mp worker path draws (worker seed
``seed * 1000003 + 0``, one stream position per batch) and stacks K
consecutive batches into one frame that the client uploads once and
trains as one chunk.

Counter addressing is the design: batch ``j`` of epoch ``e`` samples at
call count ``(e * num_batches + j) * stride``, the stride being the
stream ``CapacityPlan``'s key draws per batch (1 on a homogeneous
stream; one per (hop, edge type) plan item on a typed one, plus one for
a link stream's negatives). A block is therefore a pure function of
(seed share, sampling config, epoch, block range): any server holding
the share can produce it, which makes chunk-granular failover and a
mid-epoch resume exact.

The producer runs where the server's dataset lies, on the card by
default. A batch is sampled by the port's ``NeighborSampler`` (the
fused level kernel, or the fused hop per typed plan item), its features
are gathered with the row-gather kernel (``dist_sampling_producer``'s
gather), and the frame's K batches are stacked on the
device, ``y`` narrowed to int32 and, with ``wire_dtype='bf16'``, ``x``
cast to bfloat16 there (round to nearest even) before the frame reaches
the host in ONE device-to-host copy (``message.to_host``). A frame
enters the cache only as whole host memory, after that copy completed.
On the CPU the same code runs the plain versions.

Deliberate divergence: numpy has no bfloat16 (the JAX package ships
``ml_dtypes.bfloat16`` arrays), so a bf16 frame carries the bits of its
feature keys as ``uint16`` under the same keys; the client, which asked
for the wire dtype, views them as bfloat16 on the device. At
``wire_dtype=None`` a frame equals JAX's key for key and array for
array.

Each build is one ``remote.block_stage`` span (on the server's RPC
thread, under the client's adopted ``rpc.server.handle`` span) carrying
the build log's phase times.
"""
import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..metrics import spans
from ..sampler import (CapacityPlan, CapacityPlanError, EdgeSamplerInput,
                       NegativeSampling, NodeSamplerInput, SamplingConfig,
                       SamplingType)
from ..storage.staging import INT32_MAX, pow2_slab_cap
from ..utils.faults import fault_point
from .dist_sampling_producer import _batch_message
from .message import hetero_output_tensors, output_tensors, to_host

#: wire-dtype spellings accepted over the RPC
_BF16_NAMES = ('bf16', 'bfloat16')
#: frames a producer's ``build_log`` remembers
BUILD_LOG_LEN = 256


def _frame_nbytes(frame: Dict[str, np.ndarray]) -> int:
  """Byte size of one staged block frame (the unit of the per-tenant
  in-flight quota)."""
  return sum(int(np.asarray(v).nbytes) for v in frame.values())


def _pad_pow2_axis0(arrs: List) -> List:
  """Pad ragged leading axes to one pow2 cap (the staging-slab
  convention, ``storage/staging.py``): integer slots pad with INT32_MAX,
  everything else with zeros. Takes numpy arrays or tensors."""
  cap = pow2_slab_cap(max(int(a.shape[0]) for a in arrs))
  out = []
  for a in arrs:
    n = int(a.shape[0])
    if n == cap:
      out.append(a)
      continue
    if torch.is_tensor(a):
      integer = not (a.dtype.is_floating_point or a.dtype.is_complex or
                     a.dtype == torch.bool)
      padded = torch.full((cap,) + tuple(a.shape[1:]),
                          INT32_MAX if integer else 0, dtype=a.dtype,
                          device=a.device)
    else:
      pad_val = INT32_MAX if np.issubdtype(a.dtype, np.integer) else 0
      padded = np.full((cap,) + a.shape[1:], pad_val, a.dtype)
    padded[:n] = a
    out.append(padded)
  return out


def stack_block_frames(msgs: List[dict]) -> Dict[str, np.ndarray]:
  """Stack K per-batch messages into one block frame: every key becomes
  ``[k, ...]``. Uniform shapes stack directly; ragged leading axes
  pow2-pad per :func:`_pad_pow2_axis0`; anything else breaks the
  closed-shape contract and raises. Messages of numpy arrays stack with
  numpy; messages of tensors (a producer's, before its host copy) stack
  where each key lies."""
  frame: Dict[str, np.ndarray] = {}
  for key in msgs[0]:
    arrs = [m[key] if torch.is_tensor(m.get(key)) else np.asarray(m[key])
            for m in msgs if key in m]
    if len(arrs) != len(msgs):
      continue   # a key not present in every batch does not stack
    shapes = {tuple(a.shape) for a in arrs}
    if len(shapes) > 1:
      trailing = {tuple(a.shape[1:]) for a in arrs}
      if len(trailing) > 1 or any(a.ndim == 0 for a in arrs):
        raise ValueError(
            f'block frame key {key!r} has non-uniform trailing shapes '
            f'{sorted(shapes)}: the closed-shape contract is broken')
      arrs = _pad_pow2_axis0(arrs)
    frame[key] = (torch.stack(arrs) if torch.is_tensor(arrs[0])
                  else np.stack(arrs))
  return frame


def block_mb_per_chunk(k: int, node_cap: int, edge_cap: int,
                       feat_dim: int, wire_dtype: Optional[str] = None,
                       label_bytes: int = 4) -> float:
  """Analytic block-frame MB of one K-batch chunk (features, labels, edge
  lists, masks, seed counts): the payload the client uploads. The
  ack-only keys ('batch', 'node') ride the frame too and are not
  counted."""
  x_bytes = 2 if (wire_dtype or '').lower() in _BF16_NAMES else 4
  per_batch = (node_cap * feat_dim * x_bytes      # x
               + node_cap * label_bytes           # y
               + edge_cap * (4 + 4 + 1)           # row + col + mask
               + 8)                               # nseed/overflow scalars
  return k * per_batch / 1e6


def _is_x(key: str) -> bool:
  return key == 'x' or key.startswith('x.')


def _is_y(key: str) -> bool:
  return key == 'y' or key.startswith('y.')


class BlockSampleProducer:
  """One server-side block stream.

  Scope: supervised NODE and LINK sampling, homogeneous or typed; typed
  shapes and the counter stride come from the stream's ``CapacityPlan``.

  Args:
    dataset: the server's ``Dataset`` (graph, features, labels); the
      producer samples and gathers on its device.
    sampler_input: the seed share: ids or a ``NodeSamplerInput`` (typed
      as ``(ntype, seeds)`` or with ``input_type``), or for LINK configs
      the mp producers' dict (``{'rows', 'cols', 'label', 'neg_mode',
      'neg_amount'}``, plus ``'input_type'`` on a typed graph) or an
      ``EdgeSamplerInput``.
    sampling_config: the client's ``SamplingConfig``; its ``seed``
      already carries the per-server fold (``seed * 7919 + i``).
    wire_dtype: None (f32 features) or 'bf16' / 'bfloat16'.

  ``build_log`` keeps, for the last ``BUILD_LOG_LEN`` frames built, each
  one's range, bytes and times: the sampling and gather of its K batches,
  the device-side pack and the one host copy (device ms from CUDA events
  on a card, host ms on the CPU) and the whole build's host ms.
  """

  def __init__(self, dataset, sampler_input,
               sampling_config: SamplingConfig,
               wire_dtype: Optional[str] = None):
    from ..sampler import NeighborSampler
    cfg = sampling_config
    if cfg.sampling_type not in (SamplingType.NODE, SamplingType.LINK):
      raise ValueError('block producers cover NODE and LINK sampling; '
                       'subgraph and walk streams keep the per-batch path')
    hetero = isinstance(dataset.graph, dict)
    self._link = cfg.sampling_type == SamplingType.LINK
    self._input_type = None
    self._etype = None
    self._neg: Optional[NegativeSampling] = None
    self._rows = self._cols = self._label = None
    if self._link:
      if isinstance(sampler_input, dict):
        self._rows = np.asarray(sampler_input['rows']).reshape(-1)
        self._cols = np.asarray(sampler_input['cols']).reshape(-1)
        lab = sampler_input.get('label')
        self._label = np.asarray(lab) if lab is not None else None
        self._neg = (NegativeSampling(sampler_input['neg_mode'],
                                      sampler_input['neg_amount'])
                     if sampler_input.get('neg_mode') else None)
        self._etype = (tuple(sampler_input['input_type'])
                       if sampler_input.get('input_type') else None)
      else:
        einp = EdgeSamplerInput.cast(sampler_input)
        self._rows = np.asarray(einp.row).reshape(-1)
        self._cols = np.asarray(einp.col).reshape(-1)
        self._label = (np.asarray(einp.label)
                       if einp.label is not None else None)
        self._neg = einp.neg_sampling
        self._etype = (tuple(einp.input_type)
                       if einp.input_type is not None else None)
      if hetero and self._etype is None:
        raise CapacityPlanError(
            'BlockSampleProducer', 'hetero link seeds carry no edge '
            'type (no CapacityPlan without one)',
            'pass input_type=(src, rel, dst) on the seed share')
      self.seeds = self._rows   # the epoch order indexes seed EDGES
    else:
      if isinstance(sampler_input, (tuple, list)) and \
          len(sampler_input) == 2 and isinstance(sampler_input[0], str):
        inp = NodeSamplerInput(np.asarray(sampler_input[1]),
                               input_type=sampler_input[0])
      elif isinstance(sampler_input, NodeSamplerInput):
        inp = sampler_input
      else:
        inp = NodeSamplerInput(np.asarray(sampler_input))
      if inp.input_type is not None and not hetero:
        raise CapacityPlanError(
            'BlockSampleProducer', f'seed type {inp.input_type!r} was '
            'given for a homogeneous graph (no typed CapacityPlan '
            'exists)', 'pass untyped seeds')
      if hetero and inp.input_type is None:
        raise CapacityPlanError(
            'BlockSampleProducer', 'hetero graphs need typed seeds to '
            'derive the per-ntype CapacityPlan',
            "pass (ntype, seeds) or NodeSamplerInput(..., input_type=)")
      self._input_type = inp.input_type
      node = inp.node
      self.seeds = (node.cpu().numpy() if torch.is_tensor(node)
                    else np.asarray(node)).reshape(-1)
    if wire_dtype is not None and \
        str(wire_dtype).lower() not in _BF16_NAMES:
      raise ValueError(f'unknown wire_dtype {wire_dtype!r}; pass None '
                       "or 'bf16'")
    self.dataset = dataset
    self.config = cfg
    self.wire_dtype = (str(wire_dtype).lower()
                       if wire_dtype is not None else None)
    self._hetero = hetero
    self.device = torch.device(dataset.device)
    # the mp worker-0 stream: a block stream is one stream, rank 0
    worker_seed = (0 if cfg.seed is None else cfg.seed) * 1000003 + 0
    self._sampler = NeighborSampler(
        dataset.graph, cfg.num_neighbors, device=self.device,
        with_edge=cfg.with_edge, with_weight=cfg.with_weight,
        edge_dir=cfg.edge_dir, seed=worker_seed)
    self.plan = self._capacity_plan()
    # the stream advances _call_count by this much a batch, so random
    # block addressing scales batch indices by it
    self._key_stride = ((1 if self._neg is not None else 0) +
                        self.plan.key_draws_per_batch) if hetero else 1
    self._order_cache: Optional[tuple] = None   # (epoch, order)
    # staged frames, shared between produce-ahead builds and fetch RPCs:
    # every access holds _cache_lock (builds run outside it, under
    # _build_lock, so a cache hit never waits on a build)
    # graftlint: shared[_cache_lock]
    self._frames: Dict[Tuple[int, int, int], dict] = {}
    # tenancy accounting seams (dist_server.create_block_producer):
    # on_stage(nbytes) as a frame lands in the cache, on_fetch(nbytes) as
    # a cached frame is popped
    self.on_stage = None
    self.on_fetch = None
    self._cache_lock = threading.Lock()
    self._build_lock = threading.Lock()
    # one stream for every build: RPC threads (and the tenancy
    # scheduler's) launch on their own current streams otherwise
    self._stream = (torch.cuda.Stream(self.device)
                    if self.device.type == 'cuda' else None)
    self.build_log = collections.deque(maxlen=BUILD_LOG_LEN)

  # --------------------------------------------------------- addressing

  def num_batches(self) -> int:
    """Batches per epoch of this stream (a single worker's
    ``num_expected``)."""
    n = self.seeds.shape[0]
    bs = self.config.batch_size
    return n // bs if self.config.drop_last else -(-n // bs)

  def _epoch_order(self, epoch: int) -> np.ndarray:
    """This epoch's seed order, memoized one epoch at a time.
    ``shuffle=False`` is the identity; ``shuffle=True`` draws an
    epoch-addressed permutation (a pure function of (seed, epoch)), so a
    resume or a survivor's replay producer draws the same order."""
    cached = self._order_cache
    if cached is not None and cached[0] == epoch:
      return cached[1]
    n = self.seeds.shape[0]
    if not self.config.shuffle:
      order = np.arange(n)
    else:
      rng = np.random.default_rng(
          ((self.config.seed or 0) + 1) * 2654435761 + epoch)
      order = rng.permutation(n)
    self._order_cache = (epoch, order)
    return order

  # --------------------------------------------------------- production

  def _capacity_plan(self) -> CapacityPlan:
    """The stream's CapacityPlan: the closed shapes of its frames and the
    source of the counter stride. Link streams take their seed widths as
    the engines pad them (the cyclic tail pad keeps every batch full)."""
    cfg = self.config
    bs = cfg.batch_size
    s = self._sampler
    if not self._link:
      return CapacityPlan.from_sampler(s, bs, input_type=self._input_type,
                                       wire_dtype=self.wire_dtype)
    from ..sampler.calibrate import link_seed_width
    from ..sampler.neighbor_sampler import _round_up
    if not s.is_hetero:
      return CapacityPlan.homo(_round_up(link_seed_width(bs, self._neg)),
                               tuple(cfg.num_neighbors),
                               wire_dtype=self.wire_dtype)
    src_t, _, dst_t = self._etype
    nn = self._neg.num_negatives(bs) if self._neg is not None else 0
    if self._neg is None:
      src_w, dst_w = bs, bs
    elif self._neg.is_binary():
      src_w, dst_w = bs + nn, bs + nn
    else:  # triplet: negatives are dst candidates only
      src_w, dst_w = bs, bs + nn
    if src_t == dst_t:
      seed_caps = {src_t: _round_up(src_w + dst_w)}
    else:
      seed_caps = {src_t: _round_up(src_w), dst_t: _round_up(dst_w)}
    return CapacityPlan.hetero(list(s.graph.keys()), s._etype_fanouts,
                               seed_caps, s.edge_dir,
                               wire_dtype=self.wire_dtype)

  def _collect_tensors(self, out) -> dict:
    """Features and labels gathered where the dataset lies (the mp
    worker's gather), and the batch's message keys as tensors."""
    x, y = _batch_message(self.dataset, out, self.config.collect_features,
                          self._hetero)
    if self._hetero:
      return hetero_output_tensors(out, x, y)
    return output_tensors(out, x, y)

  def _batch_tensors(self, order: np.ndarray, epoch: int, j: int) -> dict:
    """Batch ``j`` of epoch ``epoch``: the counter stream is SET (not
    advanced) to the batch's position, so any (epoch, batch) is random
    access."""
    bs = self.config.batch_size
    idx = order[j * bs:(j + 1) * bs]
    self._sampler._call_count = \
        (epoch * self.num_batches() + j) * self._key_stride
    if self._link:
      true_n = int(idx.shape[0])
      if true_n < bs:
        # the mp worker's convention: pad the final short batch
        # cyclically, so every batch keeps the full shape
        idx = np.resize(idx, bs)
      out = self._sampler.sample_from_edges(EdgeSamplerInput(
          self._rows[idx], self._cols[idx],
          label=(self._label[idx] if self._label is not None else None),
          input_type=self._etype, neg_sampling=self._neg))
      # chunk-granular ack provenance: the seed edges this batch covered
      # and their true (pre-pad) count (sampler.capacity.ack_edge_ids)
      out.metadata['edge_batch'] = np.stack(
          [self._rows[idx], self._cols[idx]]).astype(np.int32)
      out.metadata['edge_batch_size'] = np.asarray(true_n, np.int32)
      return self._collect_tensors(out)
    out = self._sampler.sample_from_nodes(
        NodeSamplerInput(self.seeds[idx], input_type=self._input_type),
        batch_cap=bs)
    return self._collect_tensors(out)

  def _mark(self):
    """A time mark: a recorded CUDA event on a card, host time else."""
    if self._stream is None:
      return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(self._stream)
    return ev

  @staticmethod
  def _ms(a, b) -> float:
    if isinstance(a, float):
      return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)

  def build_frame(self, epoch: int, start: int, k: int) -> dict:
    """The frame of batches ``[start, start + k)`` of the epoch order:
    ``[k, ...]`` arrays, ``y`` narrowed to int32, the features cast to
    the wire dtype on the device, one host copy. Blocks are addressed by
    their first batch index, so the client's chunk size is never pinned
    on the server."""
    nb = self.num_batches()
    if not (0 <= start and start + k <= nb and k >= 1):
      raise ValueError(f'block [{start}, {start + k}) outside this '
                       f"stream's {nb}-batch epoch")
    # the block's build, sample to host frame: its phases' ms ride the
    # span (the build log's fields), so a scrape shows where a slow
    # block's time went
    with spans.span('remote.block_stage', epoch=int(epoch),
                    start=int(start), k=int(k)) as sp:
      t0 = time.perf_counter()
      ctx = (torch.cuda.stream(self._stream) if self._stream is not None
             else contextlib.nullcontext())
      with ctx:
        m0 = self._mark()
        fault_point('remote.block_stage')
        order = self._epoch_order(epoch)
        msgs = [self._batch_tensors(order, epoch, j)
                for j in range(start, start + k)]
        m1 = self._mark()
        frame = stack_block_frames(msgs)
        del msgs
        for key in list(frame):
          v = frame[key]
          if _is_y(key):
            frame[key] = v.to(torch.int32)
          elif self.wire_dtype is not None and _is_x(key):
            # round to nearest even, as ml_dtypes' cast; the bits travel
            # as uint16 (numpy has no bfloat16)
            frame[key] = v.to(torch.bfloat16).view(torch.int16)
        m2 = self._mark()
        host = to_host(frame)
        m3 = self._mark()
      for key in list(host):
        if self.wire_dtype is not None and _is_x(key):
          host[key] = host[key].view(np.uint16)
      host['#META.num_batches'] = np.asarray(k, np.int32)
      nbytes = _frame_nbytes(host)
      self.build_log.append(dict(
          epoch=int(epoch), start=int(start), k=int(k), bytes=nbytes,
          sample_ms=self._ms(m0, m1), pack_ms=self._ms(m1, m2),
          d2h_ms=self._ms(m2, m3),
          build_ms=(time.perf_counter() - t0) * 1e3))
      sp.attrs.update(self.build_log[-1])
    return host

  # ------------------------------------------------------------- serving

  def produce(self, epoch: int, start: int, k: int) -> bool:
    """Stage block (epoch, start, k) into the frame cache: the server
    half of the client's produce-ahead (the stager fires this for block
    c+1 while fetching block c). The build runs outside the cache lock,
    so a concurrent cache-hit fetch is never blocked behind it."""
    key = (int(epoch), int(start), int(k))
    with self._cache_lock:
      if key in self._frames:
        return True
    with self._build_lock:
      with self._cache_lock:      # a racing produce may have landed it
        if key in self._frames:
          return True
      frame = self.build_frame(epoch, start, k)
      with self._cache_lock:
        self._frames[key] = frame
    if self.on_stage is not None:
      self.on_stage(_frame_nbytes(frame))
    return True

  def fetch(self, epoch: int, start: int, k: int) -> dict:
    """The block frame, from the cache (popped) or built on demand. Pure:
    a retried fetch after a lost response rebuilds the identical frame,
    so the RPC is idempotent. A cache-miss build waits behind any
    in-flight produce (one sampler, one stream)."""
    key = (int(epoch), int(start), int(k))
    with self._cache_lock:
      frame = self._frames.pop(key, None)
    if frame is not None:
      if self.on_fetch is not None:
        self.on_fetch(_frame_nbytes(frame))
      return frame
    with self._build_lock:
      with self._cache_lock:    # the produce we waited on may have it
        frame = self._frames.pop(key, None)
      if frame is not None:
        if self.on_fetch is not None:
          self.on_fetch(_frame_nbytes(frame))
        return frame
      # an on-demand build is never cached, so it was never charged
      # against the in-flight quota: no release either
      return self.build_frame(epoch, start, k)

  def cached_blocks(self) -> int:
    with self._cache_lock:
      return len(self._frames)

  def cached_bytes(self) -> int:
    """Bytes of staged, unfetched frames: what a destroy or reap releases
    from the tenant's in-flight quota."""
    with self._cache_lock:
      return sum(_frame_nbytes(f) for f in self._frames.values())
