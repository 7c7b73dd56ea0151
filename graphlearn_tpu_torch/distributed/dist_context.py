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
local shards of either mesh unchanged. The 2-axis ``mesh_shape`` layout
(the hierarchical exchange) comes with the next slice.

Where JAX picks a fractional exchange's width under ``lax.cond`` with no
host round trip, the port reads the overflow verdict on the host once
per such exchange (a shape depends on it): ``verdict_syncs`` counts
those reads.
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


def _hier_later(mesh_shape):
  if mesh_shape is not None:
    raise NotImplementedError(
        f'mesh_shape={mesh_shape!r}: the 2-axis (slice, chip) mesh and its '
        'hierarchical exchange come with the next distributed slice; use '
        'the flat mesh (mesh_shape=None)')


class ShardMesh:
  """``num_partitions`` graph shards on ``device``: all of them in this
  process, or (under a ``torch.distributed`` process group of
  ``num_partitions`` ranks) the one of this rank."""

  def __init__(self, num_partitions: int, device=None, group=None):
    self.num_partitions = int(num_partitions)
    self.device = resolve_device(device)
    self.group = group
    if group is None:
      self.local_shards = list(range(self.num_partitions))
    else:
      import torch.distributed as dist
      world = dist.get_world_size(group)
      if world != self.num_partitions:
        raise ValueError(f'a process group of {world} ranks holds one '
                         f'shard each, not {self.num_partitions}')
      self.local_shards = [dist.get_rank(group)]

  @property
  def num_local(self) -> int:
    return len(self.local_shards)

  def local_rows(self, x):
    """This process's rows of a per-shard array: ``x`` itself when it
    has ``num_local`` rows, else its ``local_shards`` rows of all P."""
    if x.shape[0] == self.num_local:
      return x
    if x.shape[0] != self.num_partitions:
      raise ValueError(f'{x.shape[0]} shard rows for a mesh of '
                       f'{self.num_partitions} shards ({self.num_local} '
                       'local)')
    return x[self.local_shards]

  def all_to_all(self, x):
    """``[L, P, cap, ...]`` buckets by (source, destination) ->
    ``[L, P, cap, ...]`` by (destination, source)."""
    if self.group is None:
      return x.transpose(0, 1).contiguous()
    import torch.distributed as dist
    send = x[0].contiguous()
    as_bool = send.dtype == torch.bool
    if as_bool:
      send = send.to(torch.uint8)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=self.group)
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
  the card). ``num_partitions`` defaults to 1."""
  global _dist_context
  _hier_later(mesh_shape)
  if isinstance(devices, (list, tuple)):
    if len(devices) != 1:
      raise NotImplementedError(
          'the one-process mesh holds every shard on one device; a '
          'device group of several cards comes with a later slice')
    devices = devices[0]
  nparts = int(num_partitions or 1)
  mesh = ShardMesh(nparts, devices)
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
  size."""
  global _dist_context
  import torch.distributed as dist
  _hier_later(mesh_shape)
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
  mesh = ShardMesh(nparts, device, group=dist.group.WORLD)
  _dist_context = DistContext(world, dist.get_rank(), DistRole.WORKER,
                              group_name, nparts, mesh)
  return _dist_context
