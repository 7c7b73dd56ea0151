"""Distributed context: the shard mesh and role bookkeeping.

Counterpart of ``graphlearn_tpu/distributed/dist_context.py``. The JAX
package drives every partition from one controller over a
``jax.sharding.Mesh``; its multi-hop sample is one ``shard_map``
program with ``lax.all_to_all`` per hop. The port's counterpart of that
mesh is :class:`ShardMesh`: ``num_partitions`` shards, the device their
tensors lie on, and the two collectives the distributed engine needs
over the leading shard axis:

- one process (``init_worker_group``): the process holds all P shards,
  stacked on a leading axis of length P on one device. ``all_to_all``
  of the ``[P_src, P_dst, cap, ...]`` bucket tensor is its transpose,
  ``psum`` of a ``[P]`` vector is its sum, the same for every shard.
- a process group (``init_multihost``): each process holds one shard
  (a leading axis of length 1); ``all_to_all`` is
  ``torch.distributed.all_to_all_single`` of the ``[P, cap, ...]`` send
  buffer and ``psum`` is ``all_reduce`` (NCCL on cards, gloo on the
  CPU).

The per-shard code of the feature store and the sampler runs over the
local shards of either mesh unchanged.

``mesh_shape=(S, C)`` lays the P = S * C shards out as S slices of C
chips (partition ``s * C + c``, JAX's row-major ``('slice', 'chip')``
mesh), and ``all_to_all(x, axis='chip' | 'slice')`` exchanges along one
axis: within a slice, or within a chip column. One process transposes
the ``[S, C, ...]`` view; a process group runs ``all_to_all_single`` in
one subgroup per slice and one per chip column. The samplers and the
feature store then take the hierarchical two-stage exchange.

Where JAX picks a fractional exchange's width under ``lax.cond`` with no
host round trip, the port reads the overflow verdict on the host once
per such exchange (a shape depends on it): ``verdict_syncs`` counts
those reads.

A process group's collectives are capture-safe: each is one NCCL call on
device tensors with equal splits (no split lists, no host read, no
``barrier``), and ``local_rows`` takes this rank's row as a view, so a
``DistScanTrainer`` chunk records them into its CUDA graph. NCCL makes a
communicator at its first collective, which a capture cannot do: the
trainer's first chunk runs eagerly (its warm-up) on every rank.

Torch's counterpart of JAX's one-process mesh over several chips is one
rank per card (``init_multihost``, NCCL): ``init_worker_group`` keeps
every shard on one device.
"""
import enum
from typing import Optional

import torch

from ..utils import resolve_device

_verdict_syncs = 0


def count_verdict_sync():
  global _verdict_syncs
  _verdict_syncs += 1


def verdict_syncs() -> int:
  """Host reads of a fractional exchange's overflow verdict so far (one
  per exchange whose fractional capacity is below the full width)."""
  return _verdict_syncs


def reset_verdict_syncs():
  global _verdict_syncs
  _verdict_syncs = 0


def _check_shape(mesh_shape, nparts: int):
  """``(S, C)`` of a 2-axis layout, or None for the flat mesh."""
  if mesh_shape is None:
    return None
  s, c = (int(v) for v in mesh_shape)
  if s * c != nparts:
    raise ValueError(f'mesh_shape {tuple(mesh_shape)} != num_partitions '
                     f'{nparts}')
  return s, c


def _a2a_single(send, group):
  """``all_to_all_single`` of a ``[G, ...]`` send buffer (bools as
  bytes)."""
  import torch.distributed as dist
  send = send.contiguous()
  as_bool = send.dtype == torch.bool
  if as_bool:
    send = send.to(torch.uint8)
  out = torch.empty_like(send)
  dist.all_to_all_single(out, send, group=group)
  return out.to(torch.bool) if as_bool else out


class ShardMesh:
  """``num_partitions`` graph shards on ``device``: all of them in this
  process, or (under a ``torch.distributed`` process group of
  ``num_partitions`` ranks) the one of this rank. ``shape=(S, C)`` lays
  them out as S slices of C chips (the 2-axis mesh)."""

  def __init__(self, num_partitions: int, device=None, group=None,
               shape=None):
    self.num_partitions = int(num_partitions)
    self.device = resolve_device(device)
    self.group = group
    self.shape = _check_shape(shape, self.num_partitions)
    self._axis_groups = {}
    if group is None:
      self.local_shards = list(range(self.num_partitions))
    else:
      import torch.distributed as dist
      world = dist.get_world_size(group)
      if world != self.num_partitions:
        raise ValueError(f'a process group of {world} ranks holds one '
                         f'shard each, not {self.num_partitions}')
      self.local_shards = [dist.get_rank(group)]
      if self.shape is not None:
        self._axis_groups = self._new_axis_groups()

  def _new_axis_groups(self) -> dict:
    """This rank's subgroup of each axis: its slice's ranks ('chip') and
    its chip column's ('slice'). Every rank creates every subgroup, in
    one order, as ``new_group`` requires."""
    import torch.distributed as dist
    s_sz, c_sz = self.shape
    me = self.local_shards[0]
    out = {}
    for s in range(s_sz):
      g = dist.new_group([s * c_sz + c for c in range(c_sz)])
      if me // c_sz == s:
        out['chip'] = g
    for c in range(c_sz):
      g = dist.new_group([s * c_sz + c for s in range(s_sz)])
      if me % c_sz == c:
        out['slice'] = g
    return out

  @property
  def axis_names(self):
    return ('g',) if self.shape is None else ('slice', 'chip')

  @property
  def num_local(self) -> int:
    return len(self.local_shards)

  def local_rows(self, x):
    """This process's rows of a per-shard array: ``x`` itself when it
    has ``num_local`` rows, else its ``local_shards`` rows of all P (a
    rank's one row as a view: no index upload, which a capture could not
    make)."""
    if x.shape[0] == self.num_local:
      return x
    if x.shape[0] != self.num_partitions:
      raise ValueError(f'{x.shape[0]} shard rows for a mesh of '
                       f'{self.num_partitions} shards ({self.num_local} '
                       'local)')
    if self.num_local == 1:
      r = self.local_shards[0]
      return x[r:r + 1]
    return x[self.local_shards]

  def all_to_all(self, x, axis=None):
    """``[L, G, cap, ...]`` buckets by (source, destination) -> ``[L, G,
    cap, ...]`` by (destination, source), over all P shards (``axis``
    None, G = P), or on a 2-axis mesh along ``axis``: 'chip' (G = C, the
    shards of one slice) or 'slice' (G = S, the shards of one chip
    column)."""
    if axis is None:
      if self.group is None:
        return x.transpose(0, 1).contiguous()
      return _a2a_single(x[0], self.group)[None]
    s_sz, c_sz = self.shape
    if self.group is not None:
      return _a2a_single(x[0], self._axis_groups[axis])[None]
    rest = x.shape[2:]
    if axis == 'chip':       # [S, C_src, C_dst, ...] -> [S, C_dst, C_src]
      v = x.reshape(s_sz, c_sz, c_sz, *rest).transpose(1, 2)
      return v.reshape(self.num_partitions, c_sz, *rest).contiguous()
    assert axis == 'slice', axis
    # [S_src, C, S_dst, ...] -> [S_dst, C, S_src, ...]
    v = x.reshape(s_sz, c_sz, s_sz, *rest).transpose(0, 2)
    return v.reshape(self.num_partitions, s_sz, *rest).contiguous()

  def all_gather(self, x):
    """``[L, ...]`` per-shard values -> ``[L, P, ...]``: every shard gets
    all P (one process: the ``[P, ...]`` stack broadcast to each shard;
    a group: ``all_gather_into_tensor``)."""
    if self.group is None:
      return x.unsqueeze(0).expand(x.shape[0], *x.shape)
    import torch.distributed as dist
    send = x[0].contiguous()
    as_bool = send.dtype == torch.bool
    if as_bool:
      send = send.to(torch.uint8)
    # a flat buffer of P blocks (gloo checks the blocks against the input)
    out = torch.empty(self.num_partitions * send.numel(), dtype=send.dtype,
                      device=send.device)
    dist.all_gather_into_tensor(out, send.reshape(-1), group=self.group)
    out = out.reshape(self.num_partitions, *send.shape)
    if as_bool:
      out = out.to(torch.bool)
    return out[None]

  def psum(self, v):
    """``[L]`` per-shard values -> ``[L]`` copies of their sum over all
    shards."""
    if self.group is None:
      return v.sum().expand(v.shape[0])
    import torch.distributed as dist
    out = v.clone()
    dist.all_reduce(out, group=self.group)
    return out


class DistRole(enum.Enum):
  WORKER = 1
  SERVER = 2
  CLIENT = 3


class DistContext:
  """The role, world size and rank of this process, and its mesh."""

  def __init__(self, world_size: int, rank: int,
               role: DistRole = DistRole.WORKER,
               group_name: str = 'worker', num_partitions: int = 1,
               mesh=None):
    self.role = role
    self.world_size = world_size
    self.rank = rank
    self.group_name = group_name
    self.num_partitions = num_partitions
    self.mesh = mesh

  @property
  def worker_name(self) -> str:
    return f'{self.group_name}-{self.rank}'

  def is_worker(self) -> bool:
    return self.role == DistRole.WORKER

  def is_server(self) -> bool:
    return self.role == DistRole.SERVER

  def is_client(self) -> bool:
    return self.role == DistRole.CLIENT


_dist_context: Optional[DistContext] = None


def get_context() -> Optional[DistContext]:
  return _dist_context


def init_worker_group(world_size: int = 1, rank: int = 0,
                      group_name: str = 'worker',
                      num_partitions: Optional[int] = None,
                      devices=None, mesh_shape=None):
  """The worker context with a one-process :class:`ShardMesh`: every
  partition in this process on ``devices`` (a torch device; None means
  the card). ``num_partitions`` defaults to 1. ``mesh_shape=(S, C)``
  builds the 2-axis (slice, chip) layout (S * C == num_partitions)."""
  global _dist_context
  if isinstance(devices, (list, tuple)):
    if len(devices) != 1:
      raise NotImplementedError(
          f'init_worker_group(devices={list(devices)}): the one-process '
          'mesh holds every shard on one device. Several cards run one '
          'rank each: call init_multihost (NCCL) in one process per card, '
          'as examples/dist_train_sage_supervised.py does on a machine '
          'with several cards (--num-partitions one per card)')
    devices = devices[0]
  nparts = int(num_partitions or 1)
  mesh = ShardMesh(nparts, devices, shape=mesh_shape)
  _dist_context = DistContext(world_size, rank, DistRole.WORKER,
                              group_name, nparts, mesh)
  return _dist_context


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   group_name: str = 'worker',
                   num_partitions: Optional[int] = None,
                   mesh_shape=None, device=None):
  """Join a ``torch.distributed`` process group and build the mesh of
  one shard per process (``jax.distributed.initialize`` and the global
  mesh in JAX).

  ``coordinator_address`` is ``host:port`` of rank 0 (None: the
  ``MASTER_ADDR`` / ``MASTER_PORT`` environment); ``num_processes`` and
  ``process_id`` are the world size and this rank (None: ``WORLD_SIZE``
  / ``RANK``). ``device`` is this process's device (None: the card of
  index ``process_id`` modulo the visible cards); the backend is NCCL on
  a card and gloo on the CPU. ``num_partitions`` must equal the world
  size. ``mesh_shape=(S, C)`` lays the ranks out as S slices of C
  (subgroups per slice and per chip column); 'per_process' is JAX's one
  slice per process, here ``(world, 1)``."""
  global _dist_context
  import torch.distributed as dist
  if device is None:
    resolve_device(None)
    idx = (process_id or 0) % torch.cuda.device_count()
    device = torch.device('cuda', idx)
  device = torch.device(device)
  if device.type == 'cuda':
    if device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    torch.cuda.set_device(device)
  init = (f'tcp://{coordinator_address}' if coordinator_address
          else 'env://')
  kw = {}
  if num_processes is not None:
    kw['world_size'] = int(num_processes)
  if process_id is not None:
    kw['rank'] = int(process_id)
  dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                          init_method=init, **kw)
  world = dist.get_world_size()
  nparts = int(num_partitions or world)
  if mesh_shape == 'per_process':
    mesh_shape = (world, nparts // world)
  mesh = ShardMesh(nparts, device, group=dist.group.WORLD, shape=mesh_shape)
  _dist_context = DistContext(world, dist.get_rank(), DistRole.WORKER,
                              group_name, nparts, mesh)
  return _dist_context


def _set_server_context(num_servers, num_clients, server_rank,
                        group_name='server', num_partitions=1, mesh=None):
  """This process is sampling server ``server_rank`` of
  ``num_servers``."""
  global _dist_context
  _dist_context = DistContext(num_servers, server_rank, DistRole.SERVER,
                              group_name, num_partitions, mesh)
  return _dist_context


def _set_client_context(num_servers, num_clients, client_rank,
                        group_name='client'):
  """This process is training client ``client_rank`` of
  ``num_clients``."""
  global _dist_context
  _dist_context = DistContext(num_clients, client_rank, DistRole.CLIENT,
                              group_name)
  return _dist_context
