"""Unified feature table: hot rows on the device, cold rows in host memory.

Counterpart of ``graphlearn_tpu/data/unified_tensor.py``. A virtual
``[N, F]`` table is a device part (rows ``[0, H)``) and a host part (rows
``[H, N)``). Lookups clamp ids to ``[0, N)``.

- A table with no host part goes through the row-gather kernel on a
  card, or through the run-segmented gather-v2 kernel when
  ``use_pallas_v2`` is set (off by default, as in the JAX package;
  ``Feature.set_kernel_routing`` sets it).
- With a host part, on a card, the host part lives on pages of its own,
  page-locked and mapped for the card (``ops.mapped``), and a lookup is
  one launch of the hot/cold kernel (``ops.gather_rows_unified``), which
  reads the cold rows over UVA: no host sync. This is the reference's own
  design (its ``unified_tensor.cu``); the JAX store departs from it only
  because a TPU cannot read host memory.
- On the CPU a lookup is the JAX store's mixed gather, the kernel's
  plain version (``ops.gather_rows_unified_plain``), and sets
  ``_last_cold_cap`` as JAX does. A mixed lookup counts JAX's two
  dispatch sites (``unified_tensor.hot_gather`` / ``cold_scatter``) on
  the CPU, and the hot/cold kernel's one launch as one
  ``unified_tensor.hot_gather`` on a card.

``device`` may also be a :class:`RowSharding` (what
``DeviceGroup.sharding()`` gives), as JAX's may be a ``Sharding``: the
hot block is then row-sharded over the sharding's devices in equal
blocks (:class:`ShardedRows`, one allocation per block, also where a
device is named twice), and lookups run on its ``home`` device. On a
card a lookup is one launch of the sharded row-gather entry (no host
part) or of the sharded hot/cold entry (a host part), reading each hot
row from its owner block by address, over NVLink from another card: the
reference's peer-pointer design (``unified_tensor.cu:233-269``), where
JAX lets XLA's gather resolve the shard.
"""
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..ops import mapped
from ..ops.gather import ShardedRows, gather_rows_hbm, gather_rows_hbm2
from ..utils import resolve_device
from ..utils.trace import record_dispatch


def _as_rows(rows, dtype) -> torch.Tensor:
  t = torch.as_tensor(np.ascontiguousarray(rows)) if isinstance(
      rows, np.ndarray) else torch.as_tensor(rows)
  return t if dtype is None else t.to(dtype)


def _card(device) -> torch.device:
  """``device`` resolved, a card without an index given the current
  one."""
  device = resolve_device(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  return device


class RowSharding:
  """A hot block row-sharded over ``devices`` in order, in equal blocks
  (``DeviceGroup.sharding()``; JAX's ``NamedSharding`` over the group's
  1-axis mesh). ``home`` is the device that runs the lookups and holds
  their results (default: the first). A device may be named more than
  once: each entry still holds its own block."""

  def __init__(self, devices: Sequence, home=None):
    if not devices:
      raise ValueError('a RowSharding needs at least one device')
    self.devices = [_card(d) for d in devices]
    self.home = self.devices[0] if home is None else _card(home)

  @property
  def size(self) -> int:
    return len(self.devices)

  def ranges(self, num_rows: int) -> list:
    """``[(device, start, stop)]``: the rows each device holds of a hot
    block of ``num_rows`` rows (a multiple of the size)."""
    if num_rows % self.size:
      raise ValueError(f'{num_rows} rows do not split into {self.size} '
                       'equal blocks')
    rps = num_rows // self.size
    return [(d, s * rps, (s + 1) * rps) for s, d in enumerate(self.devices)]


class UnifiedTensor:
  """A virtual ``[N, F]`` table: device part ``[0, H)`` on ``device``,
  host part ``[H, N)`` in host memory."""

  # opt-in routing of the all-device lookup through the run-segmented
  # gather (ops.gather_rows_hbm2) at its grid point; the names are the
  # JAX package's
  use_pallas_v2 = False
  pallas_v2_block_rows = 256
  pallas_v2_run_span = 8

  def __init__(self, device=None, dtype=None):
    self.device = device
    self.dtype = dtype
    self._device_part = None   # [H, F] on the device
    self._host_part = None     # [N - H, F] CPU, mapped on a card
    self._device_rows = 0
    self._host_rows_n = 0
    self._last_cold_cap = None
    self._release = None       # unmaps the host part (a finalizer)

  def init_from(self, device_rows: Optional[np.ndarray],
                host_rows: Optional[np.ndarray]):
    """Build from a hot (device) block and a cold (host) block (numpy or
    CPU tensors; either may be None or empty)."""
    sharding = self.device if isinstance(self.device, RowSharding) else None
    device = sharding.home if sharding is not None else _card(self.device)
    self.device = device
    if device_rows is not None and np.prod(np.shape(device_rows)):
      t = _as_rows(device_rows, self.dtype)
      if sharding is not None and sharding.size > 1:
        self._device_part = ShardedRows(
            [t[a:b].to(d, copy=True).contiguous()
             for d, a, b in sharding.ranges(t.shape[0])], sharding.home)
      else:
        self._device_part = t.to(device).contiguous()
      self._device_rows = int(t.shape[0])
    if host_rows is not None and np.prod(np.shape(host_rows)):
      t = _as_rows(host_rows, self.dtype)
      if device.type == 'cuda':
        pinned = mapped.empty(t.shape, t.dtype)
        pinned.copy_(t)
        self._adopt_host(pinned)
      else:
        self._host_part = t.contiguous()
      self._host_rows_n = int(t.shape[0])
    return self

  def _adopt_host(self, tensor: torch.Tensor):
    """Map ``tensor`` (contiguous CPU rows on pages of their own) for the
    card as the host part; the mapping is released with this object."""
    mapped.register(tensor, self.device)
    if self._release is not None:
      self._release()
    self._host_part = tensor
    self._release = weakref.finalize(self, mapped.release, tensor)

  @property
  def device_part(self):
    """The hot rows: a tensor on the device, or the :class:`ShardedRows`
    of a sharding over several devices (None without hot rows)."""
    return self._device_part

  @property
  def sharded(self) -> bool:
    return isinstance(self._device_part, ShardedRows)

  @property
  def host_part(self):
    return self._host_part

  @property
  def host_rows(self) -> int:
    return self._host_rows_n

  @property
  def shape(self):
    n = self._device_rows + self._host_rows_n
    f = (self._device_part.shape[1] if self._device_part is not None
         else self._host_part.shape[1])
    return (n, f)

  @property
  def size(self) -> int:
    return self.shape[0]

  def _hot(self) -> torch.Tensor:
    if self._device_part is not None:
      return self._device_part
    return torch.empty((0, self._host_part.shape[1]),
                       dtype=self._host_part.dtype, device=self.device)

  def __getitem__(self, ids) -> torch.Tensor:
    ids = torch.as_tensor(ids, device=self.device)
    if ids.dtype not in (torch.int32, torch.int64):
      ids = ids.to(torch.int64)
    ids = ids.contiguous()
    sharded = self.sharded
    if self._host_rows_n == 0:
      if sharded:
        # the run-segmented gather reads one table: inert here, as JAX's
        # flag is on a sharded table
        return self._device_part[ids]
      if self.use_pallas_v2:
        return gather_rows_hbm2(self._device_part, ids,
                                block_rows=self.pallas_v2_block_rows,
                                run_span=self.pallas_v2_run_span)
      return gather_rows_hbm(self._device_part, ids)
    if self.device.type == 'cpu':
      if self._device_part is not None:
        # JAX's two dispatches of a mixed lookup
        record_dispatch('unified_tensor.hot_gather')
        record_dispatch('unified_tensor.cold_scatter')
      if sharded:
        rows, cap = ops.gather_rows_unified_sharded_plain(
            self._device_part.shards, self._host_part, ids)
      else:
        rows, cap = ops.gather_rows_unified_plain(self._hot(),
                                                  self._host_part, ids)
      if self._device_part is not None:
        self._last_cold_cap = cap
      return rows
    # one launch of the hot/cold kernel does both: one dispatch
    record_dispatch('unified_tensor.hot_gather')
    if sharded:
      return ops.gather_rows_unified_sharded(
          self._device_part.shards, self._device_part.pointers,
          self._host_part, ids)
    return ops.gather_rows_unified(self._hot(), self._host_part, ids)

  def share_ipc(self):
    """``(device part, host part, device)`` for another process. Sent
    through ``torch.multiprocessing``, the device part travels as a CUDA
    IPC handle (a sharded one as one handle a block, the receiver making
    its own address array) and the host part in shared memory (moved
    there here, once, and mapped again), where the receiver maps it for
    its card (:meth:`from_ipc_handle`). In the same process the parts are
    the same tensors."""
    host = self._host_part
    if host is not None and not host.is_shared():
      if self.device.type == 'cuda':
        shared = torch.empty_like(host).share_memory_()
        shared.copy_(host)
        self._adopt_host(shared)
      else:
        host.share_memory_()
    return self._device_part, self._host_part, self.device

  @classmethod
  def from_ipc_handle(cls, handle):
    device_part, host_part, device = handle
    ut = cls(resolve_device(device), device_part.dtype
             if device_part is not None else host_part.dtype)
    ut._device_part = device_part
    ut._device_rows = 0 if device_part is None else int(device_part.shape[0])
    if host_part is not None:
      if ut.device.type == 'cuda':
        ut._adopt_host(host_part)
      else:
        ut._host_part = host_part
      ut._host_rows_n = int(host_part.shape[0])
    return ut
