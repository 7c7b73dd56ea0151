"""Peer access between the cards of a device group, and the device array
of a row-sharded table's shard addresses.

A feature store whose ``DeviceGroup`` names several devices row-shards
its hot rows over them (``gather.ShardedRows``), and one
launch on the store's card reads each row from its owner shard by
address (``gather.gather_rows_sharded``): over NVLink when the owner is
another card. That needs peer access from the store's card to every
other card of the group, which :func:`enable` turns on for each ordered
pair of distinct cards (``cudaDeviceEnablePeerAccess`` through the
``gather_rows`` library). A pair that cannot reach each other raises,
naming the pair: nothing falls back to copies. A group that names one
card more than once needs no peer access for that card.

:func:`pointer_table` makes the ``[S]`` int64 array of the shards' base
addresses on the store's card once, when the store is placed, so a
captured step replays the same launch; :func:`bases_or` is the OR of
those addresses, from which the kernel picks its vector width.
"""
import ctypes
from typing import Sequence

import torch

from . import kernels


def _cuda_indices(devices) -> list:
  out = []
  for d in devices:
    d = torch.device(d)
    if d.type == 'cuda':
      idx = torch.cuda.current_device() if d.index is None else d.index
      if idx not in out:
        out.append(idx)
  return out


def enable(devices: Sequence) -> None:
  """Peer access between every ordered pair of distinct cards among
  ``devices`` (CPU devices and repeats are skipped). Raises
  ``RuntimeError`` naming the first pair that cannot reach each other,
  or on a CUDA error."""
  cards = _cuda_indices(devices)
  for a in cards:
    for b in cards:
      if a == b:
        continue
      if not torch.cuda.can_device_access_peer(a, b):
        raise RuntimeError(
            f'cuda:{a} cannot read the memory of cuda:{b} (no peer '
            'access): a device group\'s cards must reach each other '
            'directly (NVLink or PCIe peer-to-peer)')
      can = ctypes.c_int()
      err = kernels.lib('gather_rows').glt_enable_peer_access(
          a, b, ctypes.addressof(can))
      kernels.check(err, f'cudaDeviceEnablePeerAccess(cuda:{a} -> '
                    f'cuda:{b})')
      if not can.value:
        raise RuntimeError(f'cuda:{a} cannot read the memory of cuda:{b} '
                           '(cudaDeviceCanAccessPeer)')


def pointer_table(shards: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
  """The ``[S]`` int64 base addresses of ``shards`` on ``device``."""
  return torch.tensor([s.data_ptr() for s in shards], dtype=torch.int64,
                      device=device)


def bases_or(shards: Sequence[torch.Tensor]) -> int:
  """The OR of the shards' base addresses."""
  out = 0
  for s in shards:
    out |= s.data_ptr()
  return out
