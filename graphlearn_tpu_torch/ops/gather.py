"""Row gathers from a device-resident table: the feature and embedding
lookups.

Counterpart of ``graphlearn_tpu/ops/gather_pallas.py``, both
generations:

- v1, ``gather_rows_hbm``: on a CUDA tensor the wrapper launches the
  ``csrc/gather_rows.cu`` kernel (a persistent grid; each warp walks a
  run of output rows, several rows in flight at once).
- v2, ``gather_rows_hbm2``: the same gather, each full ``run_span``-row
  stretch of consecutive table rows copied at once and every other slot
  row by row. The plain version (the CPU route) follows the JAX design:
  an id sort, a per-slot plan (``plan_gather_runs``, bit-exact with
  JAX's) and the unsort. On a CUDA tensor the wrapper makes one launch
  of ``csrc/gather_runs.cu`` on the caller's ids: no sort, no plan in
  device memory; the kernel finds runs in caller order inside each
  ``block_rows`` tile, as ``plan_runs_in_tiles`` does in torch.

On CPU tensors both wrappers run their plain versions. Both clamp ids to
``[0, N)``.

The hot/cold gather, ``gather_rows_unified``: rows ``[0, H)`` of a table
on the card and rows ``[H, N)`` in host memory. On a card the wrapper
makes one call of ``csrc/gather_unified.cu`` (a memset and two kernels
on the caller's stream), which reads each distinct cold row once over
UVA from the mapped host tail (``ops.mapped``) and copies it on the card
to every other slot that names it; the wrapper allocates the kernel's
scratch (a hash table of the cold rows and a duplicate list) on the ids'
card. The number of distinct cold rows the last call read stays on the
card in ``unified_fetches`` (``unified_sharded_fetches`` for the sharded
entry), for those who ask. The plain version is the JAX store's mixed
gather (ids to the host, the cold rows gathered there and shipped padded
to a power of two, scattered into the hot gather's output). Each v2 call
bumps the reference's counter ``ops.gather_runs`` when it launches its
kernel and ``ops.gather_fallbacks`` when it does not (CPU tensors, empty
ids).

The row-sharded gathers, ``gather_rows_sharded`` and
``gather_rows_unified_sharded``: the hot rows of a store whose device
group names several devices are S equal row blocks, block s on group
device s (:class:`ShardedRows`). On a card each is one
launch of the second entry of ``csrc/gather_rows.cu`` or
``csrc/gather_unified.cu`` on the ids' card, which reads each row from
its owner block through an ``[S]`` array of the blocks' base addresses
(``ops.peer``), over NVLink for a block on another card. Their plain
versions gather each block's rows on its own device, copy them to the
ids' device and ``index_copy_`` them into place.
"""
import ctypes
import time

import torch

from .. import metrics
from ..utils.trace import record_dispatch
from . import kernels, mapped, peer

# launches of the CUDA kernels (plain-version calls do not count)
launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
runs_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
unified_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
sharded_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
unified_sharded_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
# the last hot/cold call's distinct cold rows, a [1] int64 tensor on its
# card (None before the first call); never read back on the path
unified_fetches = None  # graftlint: shared[kernels.COUNT_LOCK]
unified_sharded_fetches = None  # graftlint: shared[kernels.COUNT_LOCK]

_ROW_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor):
  """``table[clip(ids, 0, N-1)]`` in plain torch (any device)."""
  return table[ids.clamp(0, table.shape[0] - 1).long()]


def gather_rows_hbm(table: torch.Tensor, ids: torch.Tensor):
  """Gather ``table[ids]`` rows, ids clamped to ``[0, N)``.

  Args:
    table: ``[N, F]`` float32 / bfloat16 / float16 / int32, contiguous.
    ids: ``[B]`` int32 or int64 on the table's device.

  Returns ``[B, F]`` rows of ``table``'s dtype. A device group's
  :class:`ShardedRows` (what a grouped store's ``device_table()`` gives)
  goes to :func:`gather_rows_sharded`: one launch of the sharded entry on
  a card.
  """
  if isinstance(table, ShardedRows):
    return gather_rows_sharded(table.shards, table.pointers, ids)
  if table.device.type == 'cpu' and ids.device.type == 'cpu':
    return gather_rows_plain(table, ids)
  _check(table, ids, 'gather_rows_hbm')
  global launches
  out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                    device=table.device)
  if ids.shape[0] == 0:
    return out
  err = kernels.lib('gather_rows').glt_gather_rows(
      table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
      out.data_ptr(), table.shape[0], ids.shape[0],
      table.shape[1] * table.element_size(), table.device.index or 0,
      torch.cuda.current_stream(table.device).cuda_stream)
  kernels.check(err, 'gather_rows')
  with kernels.COUNT_LOCK:
    launches += 1
  return out


def gather_rows_shape(table, ids: torch.Tensor) -> dict:
  """The launch shape :func:`gather_rows_hbm` takes for ``table`` (a
  tensor, or a :class:`ShardedRows`: the sharded entry's) and ``ids`` on
  their card, with nothing launched: the persistent grid's warps, the
  rows a warp copies at once, the vector's bytes and the vectors a lane
  holds in flight."""
  if isinstance(table, ShardedRows):
    ref, bases, sharded = table.shards[0], peer.bases_or(table.shards), 1
  else:
    _check(table, ids, 'gather_rows_shape')
    ref, bases, sharded = table, table.data_ptr(), 0
  shape = (ctypes.c_longlong * 4)()
  err = kernels.lib('gather_rows').glt_gather_rows_shape(
      bases, sharded, int(ids.dtype == torch.int64), max(ids.shape[0], 1),
      ref.shape[1] * ref.element_size(), ids.device.index or 0,
      ctypes.addressof(shape))
  kernels.check(err, 'gather_rows_shape')
  return dict(zip(('grid_warps', 'rows_per_group', 'vector_bytes',
                   'vectors_per_lane'), shape))


# ---------------------------------------------------------- hot / cold


def next_pow2(n: int) -> int:
  return 1 << max(0, (n - 1).bit_length())


def gather_rows_unified_plain(hot: torch.Tensor, cold: torch.Tensor,
                              ids: torch.Tensor):
  """``(rows, cold_cap)``: :func:`gather_rows_unified` by the JAX store's
  mixed gather (``graphlearn_tpu/data/unified_tensor.py:131-183``) on any
  device: the clamped ids read on the host (on a card, a device-to-host
  sync), the hot rows gathered from ``hot`` on its device, the cold rows
  gathered on the host from ``cold`` and padded with zero rows to
  ``cold_cap = min(B, max(1, next_pow2(n_cold)))`` rows, shipped in one
  copy (pinned, on a card) and scattered into place. With no hot rows
  (``H = 0``) the host rows are shipped whole and ``cold_cap`` is None,
  as in JAX."""
  return _unified_plain(hot.shape[0], lambda r: hot.index_select(0, r),
                        cold, ids, hot.device)


def _unified_plain(n_hot: int, hot_gather, cold, ids, device):
  """The mixed gather of :func:`gather_rows_unified_plain` over ``n_hot``
  hot rows read by ``hot_gather(rows on device)``."""
  n = n_hot + cold.shape[0]
  r_dev = ids.clamp(0, n - 1).long()
  r = r_dev.cpu()

  def ship(block):
    if device.type == 'cuda':
      block = block.pin_memory()
    return block.to(device, non_blocking=True)

  if n_hot == 0:
    return ship(cold.index_select(0, r)), None
  b = r.shape[0]
  is_hot = r < n_hot
  cold_pos = torch.nonzero(~is_hot).squeeze(1)
  n_cold = int(cold_pos.shape[0])
  cold_cap = min(b, max(1, next_pow2(n_cold)))
  block = cold.new_zeros((cold_cap, cold.shape[1]))
  block[:n_cold] = cold.index_select(0, r[cold_pos] - n_hot)
  out = hot_gather(torch.where(is_hot.to(device), r_dev, 0))
  block = ship(block)
  out.index_copy_(0, cold_pos.to(device), block[:n_cold])
  return out, cold_cap


# the hot/cold kernel keys its table by cold row and records slots in 32
# bits: the cold part and the ids of one call stay below 2**31
MAX_UNIFIED_ROWS = 2**31 - 1


def unified_scratch(n_ids: int, n_cold: int, what: str):
  """``(cap, words)``: the hot/cold kernel's hash table capacity (a power
  of two at least twice the cold rows a call of ``n_ids`` ids can name,
  0 with no cold part) and its scratch size in 32-bit words (two
  counters, the keys and winning slots of the table, a duplicate list of
  ``n_ids`` pairs). Raises, naming the count, past the kernel's 32-bit
  keys and slots."""
  if n_cold > MAX_UNIFIED_ROWS:
    raise ValueError(f'{what}: the host part has {n_cold} rows; the kernel '
                     f'keys cold rows in 32 bits (at most '
                     f'{MAX_UNIFIED_ROWS})')
  if n_ids > MAX_UNIFIED_ROWS:
    raise ValueError(f'{what}: {n_ids} ids in one call; the kernel records '
                     f'slots in 32 bits (at most {MAX_UNIFIED_ROWS})')
  if n_cold == 0:
    return 0, 2
  cap = max(2, next_pow2(2 * min(n_ids, n_cold)))
  return cap, 2 + 2 * cap + 2 * n_ids


def gather_rows_unified(hot: torch.Tensor, cold: torch.Tensor,
                        ids: torch.Tensor):
  """Rows of the virtual table ``cat([hot, cold])`` at ``ids`` clamped to
  ``[0, N)``, ``N = H + cold rows``.

  Args:
    hot: ``[H, F]`` rows on the card (``H`` may be 0), contiguous.
    cold: ``[N - H, F]`` contiguous CPU rows of ``hot``'s dtype (may be
      empty); on a card they must be mapped (``ops.mapped.register``).
    ids: ``[B]`` int32 or int64 on ``hot``'s device.

  Returns ``[B, F]`` on ``hot``'s device. On CPU tensors this is
  :func:`gather_rows_unified_plain`; on a card it is one call of the
  kernel (no host sync; each distinct cold row read once) or raises.
  """
  if hot.device.type == 'cpu' and ids.device.type == 'cpu':
    return gather_rows_unified_plain(hot, cold, ids)[0]
  _check(hot, ids, 'gather_rows_unified', allow_empty=True)
  n_cold = cold.shape[0]
  if (cold.device.type != 'cpu' or cold.dim() != 2 or
      cold.dtype != hot.dtype or cold.shape[1] != hot.shape[1] or
      not cold.is_contiguous()):
    raise ValueError('gather_rows_unified: cold must be contiguous CPU '
                     f'rows of [*, {hot.shape[1]}] {hot.dtype}, got '
                     f'{tuple(cold.shape)} {cold.dtype} on {cold.device}')
  n = hot.shape[0] + n_cold
  if n == 0 and ids.shape[0] > 0:
    raise ValueError('gather_rows_unified: gather from an empty table')
  cap, words = unified_scratch(ids.shape[0], n_cold, 'gather_rows_unified')
  global unified_launches, unified_fetches
  out = torch.empty((ids.shape[0], hot.shape[1]), dtype=hot.dtype,
                    device=hot.device)
  if ids.shape[0] == 0:
    return out
  scratch = torch.empty((words,), dtype=torch.int32, device=hot.device)
  fetches = torch.empty((1,), dtype=torch.int64, device=hot.device)
  stream = torch.cuda.current_stream(hot.device)
  cold_ptr = mapped.device_pointer(cold) if n_cold else None
  err = kernels.lib('gather_unified').glt_gather_unified(
      hot.data_ptr() if hot.shape[0] else None, cold_ptr, ids.data_ptr(),
      int(ids.dtype == torch.int64), out.data_ptr(), hot.shape[0], n,
      ids.shape[0], hot.shape[1] * hot.element_size(), scratch.data_ptr(),
      cap, fetches.data_ptr(), hot.device.index or 0, stream.cuda_stream)
  kernels.check(err, 'gather_unified')
  if n_cold:
    mapped.mark_used(cold, stream)
  with kernels.COUNT_LOCK:
    unified_launches += 1
    unified_fetches = fetches
  return out


# ------------------------------------------------------------ sharded


def gather_rows_sharded_plain(shards, ids: torch.Tensor, device=None):
  """``cat(shards)[clip(ids, 0, N-1)]`` in plain torch, ``N = S * R`` for
  S blocks of R rows: for each block, ``index_select`` on its own device
  of the rows it owns, a copy to ``device`` (default: the ids'), and an
  ``index_copy_`` into the output."""
  device = ids.device if device is None else torch.device(device)
  rps = shards[0].shape[0]
  r = ids.clamp(0, rps * len(shards) - 1).long().to(device)
  out = torch.empty((r.shape[0], shards[0].shape[1]), dtype=shards[0].dtype,
                    device=device)
  owner = r // rps
  for s, shard in enumerate(shards):
    pos = torch.nonzero(owner == s).squeeze(1)
    rows = shard.index_select(0, (r[pos] - s * rps).to(shard.device))
    out.index_copy_(0, pos, rows.to(device))
  return out


def gather_rows_sharded(shards, pointers, ids: torch.Tensor):
  """Rows of the virtual table ``cat(shards)`` at ``ids`` clamped to
  ``[0, N)``.

  Args:
    shards: S contiguous ``[R, F]`` blocks of one dtype (block s holds
      rows ``[s * R, (s + 1) * R)``), all on the CPU, or on cards that
      the ids' card can read (``ops.peer.enable``); a card may hold
      several.
    pointers: ``[S]`` int64 on the ids' card, the blocks' base addresses
      (``ops.peer.pointer_table``, made once); unused on the CPU.
    ids: ``[B]`` int32 or int64.

  Returns ``[B, F]`` on the ids' device. On CPU tensors this is
  :func:`gather_rows_sharded_plain`; on a card it is one launch of the
  sharded row-gather kernel or raises.
  """
  if ids.device.type == 'cpu' and all(
      s.device.type == 'cpu' for s in shards):
    return gather_rows_sharded_plain(shards, ids)
  _check_shards(shards, pointers, ids, 'gather_rows_sharded')
  global sharded_launches
  ref = shards[0]
  out = torch.empty((ids.shape[0], ref.shape[1]), dtype=ref.dtype,
                    device=ids.device)
  if ids.shape[0] == 0:
    return out
  err = kernels.lib('gather_rows').glt_gather_rows_sharded(
      pointers.data_ptr(), len(shards), ref.shape[0], peer.bases_or(shards),
      ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
      ids.shape[0], ref.shape[1] * ref.element_size(),
      ids.device.index or 0,
      torch.cuda.current_stream(ids.device).cuda_stream)
  kernels.check(err, 'gather_rows_sharded')
  with kernels.COUNT_LOCK:
    sharded_launches += 1
  return out


class ShardedRows:
  """A device group's hot rows: S equal ``[R, F]`` blocks, block s on its
  own device and holding rows ``[s * R, (s + 1) * R)``, read on
  ``device`` (a card without an index: the current one). On a card the
  pairs of cards get peer access (``peer.enable``; a pair that cannot
  reach each other raises) and the ``[S]`` array of the blocks' base
  addresses is made on ``device`` once, here, so a captured lookup
  replays its launch. ``rows[ids]`` and :func:`gather_rows_hbm` are one
  launch of :func:`gather_rows_sharded`, or its plain version on the CPU.

  Pickled (a store's IPC handle), it travels as its blocks, each by its
  own handle, and the receiver makes its own address array."""

  def __init__(self, shards, device):
    self.shards = list(shards)
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    self.device = device
    ref = self.shards[0]
    self.rows_per_shard = int(ref.shape[0])
    self.shape = torch.Size((self.rows_per_shard * len(self.shards),
                             ref.shape[1]))
    self.dtype = ref.dtype
    self.pointers = None
    if self.device.type == 'cuda':
      peer.enable([self.device] + [s.device for s in self.shards])
      self.pointers = peer.pointer_table(self.shards, self.device)

  def __getitem__(self, ids) -> torch.Tensor:
    ids = torch.as_tensor(ids, device=self.device)
    if ids.dtype not in (torch.int32, torch.int64):
      ids = ids.to(torch.int64)
    return gather_rows_sharded(self.shards, self.pointers, ids.contiguous())

  def __reduce__(self):
    return (ShardedRows, (self.shards, self.device))


def gather_rows_unified_sharded_plain(shards, cold: torch.Tensor,
                                      ids: torch.Tensor, device=None):
  """``(rows, cold_cap)``: :func:`gather_rows_unified_plain` with the hot
  part held as ``shards`` (read by :func:`gather_rows_sharded_plain`);
  the output on ``device`` (default: the ids')."""
  device = ids.device if device is None else torch.device(device)
  return _unified_plain(
      shards[0].shape[0] * len(shards),
      lambda r: gather_rows_sharded_plain(shards, r, device), cold, ids,
      device)


def gather_rows_unified_sharded(shards, pointers, cold: torch.Tensor,
                                ids: torch.Tensor):
  """Rows of the virtual table ``cat([*shards, cold])`` at ``ids`` clamped
  to ``[0, N)``: :func:`gather_rows_unified` with the hot part held as
  ``shards`` (as :func:`gather_rows_sharded` takes them, with their
  ``pointers``). ``cold`` as :func:`gather_rows_unified` takes it (mapped
  for the ids' card). On CPU tensors this is
  :func:`gather_rows_unified_sharded_plain`; on a card it is one call of
  the sharded hot/cold kernel (each distinct cold row read once) or
  raises."""
  if ids.device.type == 'cpu' and all(
      s.device.type == 'cpu' for s in shards):
    return gather_rows_unified_sharded_plain(shards, cold, ids)[0]
  _check_shards(shards, pointers, ids, 'gather_rows_unified_sharded')
  ref = shards[0]
  n_cold = cold.shape[0]
  if (cold.device.type != 'cpu' or cold.dim() != 2 or
      cold.dtype != ref.dtype or cold.shape[1] != ref.shape[1] or
      not cold.is_contiguous()):
    raise ValueError('gather_rows_unified_sharded: cold must be contiguous '
                     f'CPU rows of [*, {ref.shape[1]}] {ref.dtype}, got '
                     f'{tuple(cold.shape)} {cold.dtype} on {cold.device}')
  cap, words = unified_scratch(ids.shape[0], n_cold,
                               'gather_rows_unified_sharded')
  global unified_sharded_launches, unified_sharded_fetches
  out = torch.empty((ids.shape[0], ref.shape[1]), dtype=ref.dtype,
                    device=ids.device)
  if ids.shape[0] == 0:
    return out
  scratch = torch.empty((words,), dtype=torch.int32, device=ids.device)
  fetches = torch.empty((1,), dtype=torch.int64, device=ids.device)
  stream = torch.cuda.current_stream(ids.device)
  cold_ptr = mapped.device_pointer(cold) if n_cold else None
  err = kernels.lib('gather_unified').glt_gather_unified_sharded(
      pointers.data_ptr(), len(shards), ref.shape[0], peer.bases_or(shards),
      cold_ptr, ids.data_ptr(), int(ids.dtype == torch.int64),
      out.data_ptr(), ref.shape[0] * len(shards) + n_cold, ids.shape[0],
      ref.shape[1] * ref.element_size(), scratch.data_ptr(), cap,
      fetches.data_ptr(), ids.device.index or 0, stream.cuda_stream)
  kernels.check(err, 'gather_unified_sharded')
  if n_cold:
    mapped.mark_used(cold, stream)
  with kernels.COUNT_LOCK:
    unified_sharded_launches += 1
    unified_sharded_fetches = fetches
  return out


def _check_shards(shards, pointers, ids, what):
  if ids.device.type != 'cuda':
    raise ValueError(f'{what}: ids on {ids.device} and shards on '
                     f'{sorted({str(s.device) for s in shards})}; the kernel '
                     'needs the ids on a CUDA device and every shard on a '
                     'card')
  ref = shards[0] if shards else None
  if ref is None or ref.dim() != 2 or ref.dtype not in _ROW_DTYPES or \
      ref.shape[0] == 0:
    raise ValueError(f'{what}: shards must be non-empty 2-D blocks of '
                     f'{_ROW_DTYPES}')
  for s in shards:
    if (s.device.type != 'cuda' or s.shape != ref.shape or
        s.dtype != ref.dtype or not s.is_contiguous()):
      raise ValueError(f'{what}: every shard must be a contiguous '
                       f'{tuple(ref.shape)} {ref.dtype} block on a card, got '
                       f'{tuple(s.shape)} {s.dtype} on {s.device}')
  if (pointers is None or pointers.device != ids.device or
      pointers.dtype != torch.int64 or
      tuple(pointers.shape) != (len(shards),)):
    raise ValueError(f'{what}: pointers must be the [{len(shards)}] int64 '
                     f'shard addresses on {ids.device} '
                     '(ops.peer.pointer_table)')
  if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64) or \
      not ids.is_contiguous():
    raise ValueError(f'{what}: ids must be contiguous 1-D int32/int64, got '
                     f'{tuple(ids.shape)} {ids.dtype}')


# ------------------------------------------------------------------ v2

# plan encoding: bits 30-31 carry the per-slot copy kind, the low 30 bits
# the clamped table row. Kind 2 occupies the int32 sign bit, so decode
# masks after the shift (torch's >> on int32 is arithmetic).
_KIND_SINGLE = 0   # this slot copies its own row
_KIND_RUN = 1      # this slot starts a full ``run_span``-row copy
_KIND_COVERED = 2  # covered by a preceding run start: no copy
_ROW_MASK = (1 << 30) - 1


def decode_gather_plan(plan):
  """(kind, row) from a packed :func:`plan_gather_runs` plan — the
  sign-bit-safe decode."""
  return (plan >> 30) & 3, plan & _ROW_MASK


def plan_gather_runs(sid: torch.Tensor, n_rows: int, block_rows: int,
                     run_span: int) -> torch.Tensor:
  """Per-slot copy plan over a sorted ``[B]`` int32 id vector, in torch
  ops, bit-exact against the JAX package's plan.

  A slot copies its own row (kind 0), starts one ``run_span``-row copy
  of itself and the next ``run_span - 1`` slots (kind 1: only when those
  slots hold strictly consecutive ids, the run stays inside its
  ``block_rows`` block and inside the table), or is covered by such a
  start (kind 2). Only full-length runs copy as one; shorter runs
  decompose into singles. Decode with :func:`decode_gather_plan`.

  The JAX plan finds run starts and lengths with ``cummax``/``cummin``
  scans; here each maximal +1-step segment (broken at block boundaries)
  gets an id by ``cumsum`` and its first slot by a ``scatter_reduce``
  min, from which every slot's sub-run start (every ``run_span`` slots
  from the segment's first) and verdict follow elementwise — the same
  plan, without the index-carrying scans, which are slow on the GPU.
  """
  sid = sid.to(torch.int32)
  if sid.shape[0] == 0:
    return sid.clone()
  j = torch.arange(sid.shape[0], dtype=torch.int64, device=sid.device)
  return _plan_stretches(sid, n_rows, j % block_rows == 0, run_span)


def _plan_stretches(sid: torch.Tensor, n_rows: int, start0: torch.Tensor,
                    run_span: int) -> torch.Tensor:
  """The packed plan of int32 ids ``sid`` whose stretches may also break
  where the bool ``start0`` is set (block or tile starts; ``start0[0]``
  set)."""
  b = sid.shape[0]
  dev = sid.device
  j = torch.arange(b, dtype=torch.int64, device=dev)
  # maximal +1-step segments, also broken where start0 is set
  start0[1:] |= sid[1:] != sid[:-1] + 1
  seg = torch.cumsum(start0, 0) - 1
  # first slot of every segment; entry seg+1 is the next segment's first
  # (b past the last segment)
  first = torch.full((b + 1,), b, dtype=torch.int64, device=dev)
  first.scatter_reduce_(0, seg, j, 'amin')
  # position in the segment's current run_span-slot sub-run
  r = (j - first[seg]) % run_span
  # a sub-run is full when all run_span slots lie in its segment and its
  # rows in the table (consecutive ids: its first row is sid - r)
  full = ((j - r + run_span <= first[seg + 1]) &
          (sid - r + run_span <= n_rows))
  kind = torch.where(full, torch.where(r == 0, _KIND_RUN, _KIND_COVERED),
                     _KIND_SINGLE).to(torch.int32)
  return sid | (kind << 30)


def _sorted_plan(n: int, ids: torch.Tensor, block_rows: int, run_span: int,
                 presorted: bool):
  """(plan, perm, span): clamp, sort (unless presorted), pad to the
  block multiple with row 0, plan. ``perm`` maps sorted slot -> caller
  slot (None when presorted)."""
  _check_grid(n, block_rows, run_span)
  ids = ids.clamp(0, n - 1).to(torch.int32)
  if presorted:
    sid, perm = ids, None
  else:
    sid, perm = torch.sort(ids, stable=True)
  b = ids.shape[0]
  g = min(block_rows, b)
  span = min(run_span, g)
  pad = (-b) % g
  if pad:
    # pad slots hold row 0 as their own singles; never written out
    sid = torch.cat([sid, sid.new_zeros(pad)])
  return plan_gather_runs(sid, n, g, span), perm, span


def _check_grid(n: int, block_rows: int, run_span: int):
  if block_rows < 1 or run_span < 1:
    raise ValueError(f'block_rows and run_span must be >= 1, got '
                     f'{block_rows}, {run_span}')
  if n > _ROW_MASK:
    raise ValueError(f'gather v2 packs rows into 30 bits; the table has '
                     f'{n} rows')


# the kernel plans at most this many slots of a block at once: a longer
# block is cut into tiles of this length from its start
GATHER_RUNS_MAX_TILE = 4096


def plan_runs_in_tiles(ids: torch.Tensor, n_rows: int, block_rows: int,
                       run_span: int) -> torch.Tensor:
  """The gather-v2 kernel's plan, in torch: over the caller-order ``[B]``
  ids, clamped to ``[0, n_rows)``, without a sort.

  Slots fall into tiles of ``block_rows`` consecutive slots (a block
  longer than :data:`GATHER_RUNS_MAX_TILE` is cut into tiles of that
  length from its start). Inside a tile, each maximal stretch of +1-step
  ids is split into ``run_span``-slot pieces from its first slot; a piece
  whose ``run_span`` slots all lie in the stretch is one run: its first
  slot copies the ``run_span`` rows at once (kind 1) and the others are
  covered (kind 2); every other slot copies its own row (kind 0).
  Returns the clamped rows with the kind in bits 30-31, packed as
  :func:`plan_gather_runs` packs them; decode with
  :func:`decode_gather_plan`. Apply with :func:`apply_gather_plan`.
  """
  _check_grid(n_rows, block_rows, run_span)
  b = ids.shape[0]
  rows = ids.clamp(0, n_rows - 1).to(torch.int32)
  if b == 0:
    return rows
  j = torch.arange(b, dtype=torch.int64, device=rows.device)
  start = (j % block_rows) % min(block_rows, GATHER_RUNS_MAX_TILE) == 0
  return _plan_stretches(rows, n_rows, start, run_span)


def apply_gather_plan(table: torch.Tensor, plan: torch.Tensor,
                      run_span: int) -> torch.Tensor:
  """Execute a packed caller-order plan in plain torch: every kind-0 slot
  copies its row, every kind-1 slot copies ``run_span`` consecutive rows
  into itself and the next ``run_span - 1`` slots, kind-2 slots copy
  nothing. Slots no copy writes stay zero."""
  b, f = plan.shape[0], table.shape[1]
  out = table.new_zeros((b, f))
  if b == 0:
    return out
  kind, row = decode_gather_plan(plan)
  single = torch.nonzero(kind == _KIND_SINGLE).squeeze(1)
  out[single] = table[row[single].long()]
  starts = torch.nonzero(kind == _KIND_RUN).squeeze(1)
  off = torch.arange(run_span, device=table.device)
  out[(starts[:, None] + off).reshape(-1)] = \
      table[(row[starts].long()[:, None] + off).reshape(-1)]
  return out


def gather_rows_hbm2_plain(table: torch.Tensor, ids: torch.Tensor,
                           block_rows: int = 256, run_span: int = 8,
                           presorted: bool = False):
  """The same function as :func:`gather_rows_hbm2` in plain torch: sort,
  plan, one indexed copy for the kind-0 slots and one for every row of
  every kind-1 run, then the unsort. Equals ``table[clip(ids)]``."""
  b = ids.shape[0]
  if b == 0:
    return table.new_empty((0, table.shape[1]))
  plan, perm, span = _sorted_plan(table.shape[0], ids, block_rows,
                                  run_span, presorted)
  out = apply_gather_plan(table, plan, span)[:b]
  if perm is None:
    return out
  res = torch.empty_like(out)
  res[perm] = out
  return res


def gather_rows_hbm2(table: torch.Tensor, ids: torch.Tensor,
                     block_rows: int = 256, run_span: int = 8,
                     presorted: bool = False):
  """Gather ``table[ids]`` (ids clamped to ``[0, N)``), each full
  ``run_span``-row stretch of consecutive rows copied at once.

  Args:
    table: ``[N, F]`` float32 / bfloat16 / float16 / int32, contiguous,
      N < 2**30; any row width.
    ids: ``[B]`` int32 or int64 on the table's device.
    block_rows: block of slots (runs never cross a block boundary).
    run_span: rows per run copy.
    presorted: the caller's ids are already ascending. The plain version
      skips its sort and unsort; the kernel finds runs in caller order
      anyway, so the flag changes no output.

  Returns ``[B, F]`` rows in caller order. On CPU tensors this is
  :func:`gather_rows_hbm2_plain`; a CUDA table makes one launch of the
  kernel or raises.
  """
  if table.device.type == 'cpu' and ids.device.type == 'cpu':
    metrics.inc('ops.gather_fallbacks')
    return gather_rows_hbm2_plain(table, ids, block_rows, run_span,
                                  presorted)
  t0 = time.perf_counter()
  record_dispatch('gather2')
  out = _gather_runs_launch(table, ids, block_rows, run_span)
  if ids.shape[0]:
    metrics.inc('ops.gather_runs')
  else:
    metrics.inc('ops.gather_fallbacks')
  # the host's enqueue time, not the card's: a liveness / regression
  # signal, never a throughput claim
  metrics.observe('ops.gather_ms', (time.perf_counter() - t0) * 1e3)
  return out


def _gather_runs_launch(table, ids, block_rows, run_span, plan_out=None):
  """One launch of ``csrc/gather_runs.cu``; ``plan_out`` (a ``[B]`` int32
  tensor on the table's device, or None) receives the kernel's own plan,
  packed as :func:`plan_runs_in_tiles` packs it."""
  _check(table, ids, 'gather_rows_hbm2')
  _check_grid(table.shape[0], block_rows, run_span)
  global runs_launches
  b = ids.shape[0]
  out = torch.empty((b, table.shape[1]), dtype=table.dtype,
                    device=table.device)
  if b == 0:
    return out
  # a block of b or more slots is one block; a run longer than 2**31 - 1
  # slots never fits one
  err = kernels.lib('gather_runs').glt_gather_runs(
      table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
      out.data_ptr(), None if plan_out is None else plan_out.data_ptr(),
      table.shape[0], b, table.shape[1] * table.element_size(),
      min(block_rows, b), min(run_span, 2 ** 31 - 1),
      table.device.index or 0,
      torch.cuda.current_stream(table.device).cuda_stream)
  kernels.check(err, 'gather_runs')
  with kernels.COUNT_LOCK:
    runs_launches += 1
  return out


def _check(table, ids, what, allow_empty=False):
  if table.device.type != 'cuda' or ids.device != table.device:
    raise ValueError(f'{what}: table on {table.device} and ids on '
                     f'{ids.device}; the kernel needs both on one CUDA '
                     'device')
  if table.dim() != 2 or table.dtype not in _ROW_DTYPES:
    raise ValueError(f'{what}: table must be 2-D of {_ROW_DTYPES}, got '
                     f'{tuple(table.shape)} {table.dtype}')
  if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
    raise ValueError(f'{what}: ids must be 1-D int32/int64, got '
                     f'{tuple(ids.shape)} {ids.dtype}')
  if not (table.is_contiguous() and ids.is_contiguous()):
    raise ValueError(f'{what}: table and ids must be contiguous')
  if table.shape[0] == 0 and ids.shape[0] > 0 and not allow_empty:
    raise ValueError(f'{what}: gather from an empty table')
