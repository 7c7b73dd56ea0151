"""Feature store: hot rows on the device, cold rows in host memory.

Counterpart of ``graphlearn_tpu/data/feature.py``. Rows are split by
``split_ratio`` (or ``cache_rows``) into a device prefix and a host
tail (``UnifiedTensor``); ``id2index`` carries the hotness reorder
(``data/reorder.py``), so after ``sort_by_in_degree`` the prefix holds
the most read rows. On a card a lookup with a host tail is one launch of
the hot/cold kernel, which reads the cold rows over UVA.

``DeviceGroup`` keeps JAX's fields and rules
(``graphlearn_tpu/data/feature.py:122-140``). A one-device group places
the hot block on that device. A larger group row-shards the hot block
over its devices in equal blocks (``ops.ShardedRows``): a
full split pads the block up to a multiple of the group size with zero
rows (so ``device_table()`` stays usable), a mixed split rounds it down
(the demoted rows stay on the host), and further groups are replicas,
which placement across processes handles (as in JAX). Lookups run on the
store's ``device`` (default: the group's first), each hot row read from
its owner block by address: over NVLink from another card, the
reference's peer-pointer design. Unlike JAX's mesh, a group may name one
device more than once (each entry its own block): one card then runs the
sharded layout and its kernels.
"""
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device
from .unified_tensor import RowSharding, UnifiedTensor


def _fill_value(dtype):
  """``jnp.take``'s fill for an out-of-range row in its default mode."""
  if dtype.is_floating_point:
    return float('nan')
  return torch.iinfo(dtype).min


class DeviceGroup:
  """A group of devices that jointly hold one replica of the hot rows
  (``graphlearn_tpu/data/feature.py:DeviceGroup``)."""

  def __init__(self, group_id: int, device_list: Sequence):
    self.group_id = group_id
    self.device_list = list(device_list)

  @property
  def size(self):
    return len(self.device_list)

  def sharding(self) -> RowSharding:
    """The row sharding of a hot block over this group, the first device
    its home (``RowSharding.ranges(rows)``: the rows each device holds)."""
    return RowSharding(self.device_list)


class Feature:
  """2-D feature store with a hot/cold split.

  Args:
    feature_array: ``[N, F]`` host rows (already reordered when
      ``id2index`` is given).
    split_ratio: fraction of rows kept on the device (0 = all on the
      host, the JAX default; 1 = all on the device).
    device_group_list: optional ``DeviceGroup``s; the first places the
      hot block (row-sharded over a group of several devices).
    device: torch device for the hot part, or of a grouped store the
      device that runs its lookups, and for lookups' results (None means
      the group's first device, else the card).
    with_device: False keeps every row on the host.
    id2index: optional ``[N]`` old-id -> row map (the hotness reorder).
    dtype: optional storage dtype (e.g. ``torch.bfloat16``).
    cache_rows: absolute device row count (overrides ``split_ratio``).
  """

  def __init__(
      self,
      feature_array,
      split_ratio: float = 0.0,
      device_group_list: Optional[List[DeviceGroup]] = None,
      device=None,
      with_device: bool = True,
      id2index: Optional[np.ndarray] = None,
      dtype=None,
      cache_rows: Optional[int] = None,
  ):
    self.feature_array = np.asarray(feature_array)
    n = self.feature_array.shape[0]
    self.cache_rows = (min(max(int(cache_rows), 0), n)
                       if cache_rows is not None else None)
    if self.cache_rows is not None and n:
      split_ratio = self.cache_rows / n
    self.split_ratio = float(split_ratio)
    self.device_group_list = device_group_list
    if device_group_list:
      group = device_group_list[0]
      if group.device_list and device is None:
        device = group.device_list[0]
    self.device = resolve_device(device)
    self.with_device = with_device
    self._id2index = id2index
    self.dtype = dtype
    self._unified = None
    self._id2index_dev = None
    self._kernel_routing = None

  def set_kernel_routing(self, use_pallas_v2: bool = False,
                         block_rows: int = 256, run_span: int = 8):
    """Route the all-device lookup (``feature[ids]``) through the
    run-segmented gather (``ops.gather_rows_hbm2``) at the given grid
    point instead of the row-gather kernel. The loaders' fused collate
    gather is not routed, as in the JAX package."""
    self._kernel_routing = dict(use_pallas_v2=bool(use_pallas_v2),
                                pallas_v2_block_rows=int(block_rows),
                                pallas_v2_run_span=int(run_span))
    if self._unified is not None:
      for k, v in self._kernel_routing.items():
        setattr(self._unified, k, v)

  def lazy_init(self):
    """Place the rows: the first ``H`` on the device, the rest on the
    host (``H`` from ``cache_rows``, else ``int(N * split_ratio)``; 0
    without ``with_device``). A group of several devices row-shards the
    ``H`` rows over them, ``H`` padded up to a multiple of the group size
    with zero rows when every row is hot, else rounded down to one."""
    if self._unified is not None:
      return
    n = self.feature_array.shape[0]
    if not self.with_device:
      hot = 0
    elif self.cache_rows is not None:
      hot = self.cache_rows
    else:
      hot = int(n * self.split_ratio)
    place = self.device
    hot_block = self.feature_array[:hot] if hot else None
    if self.device_group_list and self.device_group_list[0].size > 1:
      group = self.device_group_list[0]
      place = RowSharding(group.device_list, self.device)
      rem = hot % group.size
      if rem and hot == n:
        pad = np.zeros((group.size - rem,) + self.feature_array.shape[1:],
                       self.feature_array.dtype)
        hot_block = np.concatenate([self.feature_array, pad])
        hot += group.size - rem
      elif rem:
        hot -= rem
        hot_block = self.feature_array[:hot] if hot else None
    self._unified = UnifiedTensor(place, self.dtype).init_from(
        hot_block, self.feature_array[hot:] if hot < n else None)
    if place is not self.device:
      # a grouped store's lookups run on the sharding's home, a card with
      # its index: not whatever card is current when a lookup comes
      self.device = self._unified.device
    if self._kernel_routing is not None:
      for k, v in self._kernel_routing.items():
        setattr(self._unified, k, v)
    if self._id2index is not None:
      self._id2index_dev = torch.as_tensor(np.asarray(self._id2index)).to(
          self.device)

  @property
  def id2index(self):
    return self._id2index

  @property
  def unified(self) -> UnifiedTensor:
    self.lazy_init()
    return self._unified

  def __getitem__(self, ids) -> torch.Tensor:
    """Rows for global node ids. FILL (-1) slots read storage row 0,
    after the id2index remap, as in the JAX package. An id past the
    table (or past ``id2index``) gives the fill row of ``jnp.take``'s
    default mode: NaN for floats, the dtype's least value for integers."""
    self.lazy_init()
    ids = torch.as_tensor(ids, device=self.device).long()
    pad = ids < 0
    idx = torch.clamp(ids, min=0)
    oob = torch.zeros_like(pad)
    if self._id2index_dev is not None:
      remap = self._id2index_dev
      oob = idx >= remap.shape[0]
      idx = remap[torch.clamp(idx, max=remap.shape[0] - 1)].long()
    idx = torch.where(pad, 0, idx)
    n = self._unified.shape[0]
    oob = ~pad & (oob | (idx >= n) | (idx < -n))
    idx = torch.where(idx < 0, idx + n, idx)
    rows = self._unified[idx]
    return rows.masked_fill_(oob[:, None], _fill_value(rows.dtype))

  def device_table(self):
    """``(feats, id2index)`` on the device when every row is there (the
    loaders' fused collate gathers from it), else None: a store with a
    host part is read through ``__getitem__``. A grouped store's
    ``feats`` is its ``ShardedRows`` (``ops.gather_rows_hbm`` routes it
    to the sharded kernel)."""
    self.lazy_init()
    if self._unified.host_rows or self._unified.device_part is None:
      return None
    return self._unified.device_part, self._id2index_dev

  def cpu_get(self, ids) -> np.ndarray:
    """Rows for global node ids gathered on the host, as numpy (a store
    rebuilt from an IPC handle reads its own two parts)."""
    ids = np.asarray(ids)
    if self._id2index is not None:
      ids = np.asarray(self._id2index)[ids]
    if self.feature_array is not None:
      return self.feature_array[ids]
    ut = self.unified
    rows = np.arange(ut.size)[ids]      # numpy's index rules and errors
    h = ut._device_rows
    hot = torch.as_tensor(rows < h)
    out = torch.empty((rows.shape[0], ut.shape[1]),
                      dtype=(ut.device_part if h else ut.host_part).dtype)
    r = torch.as_tensor(rows)
    if h:
      out[hot] = ut.device_part[r[hot].to(ut.device)].cpu()
    if ut.host_rows:
      out[~hot] = ut.host_part[r[~hot] - h]
    return (out.float() if out.dtype == torch.bfloat16 else out).numpy()

  @property
  def shape(self):
    if self.feature_array is not None:
      return tuple(self.feature_array.shape)
    return tuple(self.unified.shape)

  @property
  def size(self) -> int:
    return int(self.shape[0])

  def __len__(self):
    return self.size

  def share_ipc(self):
    """A handle another process rebuilds the store from
    (:meth:`from_ipc_handle`): the unified table's parts (sent through
    ``torch.multiprocessing``, the device part as a CUDA IPC handle, the
    host part in shared memory), the split and the remap."""
    return (self.unified.share_ipc(), self.split_ratio, self.device,
            self.with_device, self._id2index, self.dtype, self.cache_rows)

  def __reduce__(self):
    # pickled (e.g. sent to a torch.multiprocessing worker), a store
    # travels as its IPC handle
    return (Feature.from_ipc_handle, (self.share_ipc(),))

  @classmethod
  def from_ipc_handle(cls, handle):
    parts, split_ratio, device, with_device, id2index, dtype, *rest = handle
    feat = cls.__new__(cls)
    feat.feature_array = None
    feat.cache_rows = rest[0] if rest else None
    feat.split_ratio = split_ratio
    feat.device_group_list = None
    feat.device = resolve_device(device)
    feat.with_device = with_device
    feat._id2index = id2index
    feat.dtype = dtype
    feat._kernel_routing = None
    feat._unified = UnifiedTensor.from_ipc_handle(parts)
    feat._id2index_dev = (None if id2index is None else torch.as_tensor(
        np.asarray(id2index)).to(feat.device))
    return feat
