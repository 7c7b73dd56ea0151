"""Hop keys of a chunk of training steps, derived on the device.

Counterpart of the key derivation inside the JAX ``ScanTrainer``'s
scanned chunk (``graphlearn_tpu/loader/scan_epoch.py:249-254``: the
step counts ``count0 + start + iota`` are traced values, and each step's
key is ``fold_in(base_key, count)``, split by the sampler into one key
per hop). ``step_keys`` writes a chunk's ``[K, n_hops, 2]`` hop keys from
a base key and the chunk's first count, both read from device memory:
on a CUDA tensor one launch of ``csrc/step_keys.cu``, so a captured CUDA
graph draws new keys whenever the counter buffer holds a new count. On
CPU tensors it runs the plain version, ``random.step_keys_plain``.
``dist_step_keys`` is the distributed chunk's counterpart
(``graphlearn_tpu/loader/scan_epoch.py:700-706``): ``[K, P, n_hops, 2]``
keys, ``split(fold_in(base_key, count), P)[shard]`` split once per hop,
one launch of the same source's second entry (plain:
``random.dist_step_keys_plain``).
"""
import torch

from .. import random as trandom
from . import kernels

# launches of the CUDA kernels (plain-version calls do not count)
launches = 0  # graftlint: shared[kernels.COUNT_LOCK]
dist_launches = 0  # graftlint: shared[kernels.COUNT_LOCK]


def _check_inputs(what, base_key, counter):
  dev = base_key.device
  if dev.type != 'cuda' or counter.device != dev:
    raise ValueError(f'{what}: base key on {base_key.device} and counter '
                     f'on {counter.device}; the kernel needs both on one '
                     'CUDA device')
  if base_key.dtype != torch.int64 or base_key.shape != (2,) or \
      counter.dtype != torch.int64 or counter.numel() != 1 or \
      not (base_key.is_contiguous() and counter.is_contiguous()):
    raise ValueError(f'{what}: needs a contiguous [2] int64 key and a '
                     f'one-element int64 counter, got {tuple(base_key.shape)} '
                     f'{base_key.dtype}, {tuple(counter.shape)} '
                     f'{counter.dtype}')
  return dev


def step_keys(base_key: torch.Tensor, counter: torch.Tensor, n_steps: int,
              n_hops: int):
  """The hop keys of steps ``counter + 0 .. counter + n_steps - 1``.

  Args:
    base_key: ``[2]`` int64 threefry key (the sampler's base key).
    counter: 0-d or ``[1]`` int64, the count of the chunk's first step
      (taken modulo 2**32 with each step's offset, as JAX's int32 count
      wraps), on the key's device.
    n_steps / n_hops: static sizes.

  Returns ``[n_steps, n_hops, 2]`` int64 words: row ``[j, h]`` is
  ``split(fold_in(base_key, counter + j), n_hops)[h]``.
  """
  if base_key.device.type == 'cpu' and counter.device.type == 'cpu':
    counts = counter.reshape(()) + torch.arange(n_steps, dtype=torch.int64)
    return trandom.step_keys_plain(base_key, counts, n_hops)
  dev = _check_inputs('step_keys', base_key, counter)
  global launches
  out = torch.empty((n_steps, n_hops, 2), dtype=torch.int64, device=dev)
  if n_steps * n_hops == 0:
    return out
  err = kernels.lib('step_keys').glt_step_keys(
      base_key.data_ptr(), counter.data_ptr(), n_steps, n_hops,
      out.data_ptr(), dev.index or 0,
      torch.cuda.current_stream(dev).cuda_stream)
  kernels.check(err, 'step_keys')
  with kernels.COUNT_LOCK:
    launches += 1
  return out


def dist_step_keys(base_key: torch.Tensor, counter: torch.Tensor,
                   n_steps: int, n_parts: int, n_hops: int):
  """The keys of a distributed chunk of steps ``counter + 0 .. counter +
  n_steps - 1`` over ``n_parts`` shards.

  Same arguments as :func:`step_keys`, and ``n_parts`` (P). Returns
  ``[n_steps, n_parts, n_hops, 2]`` int64 words: row ``[j, p, h]`` is
  ``split(split(fold_in(base_key, counter + j), n_parts)[p], n_hops)[h]``.
  """
  if base_key.device.type == 'cpu' and counter.device.type == 'cpu':
    counts = counter.reshape(()) + torch.arange(n_steps, dtype=torch.int64)
    return trandom.dist_step_keys_plain(base_key, counts, n_parts, n_hops)
  dev = _check_inputs('dist_step_keys', base_key, counter)
  global dist_launches
  out = torch.empty((n_steps, n_parts, n_hops, 2), dtype=torch.int64,
                    device=dev)
  if n_steps * n_parts * n_hops == 0:
    return out
  err = kernels.lib('step_keys').glt_dist_step_keys(
      base_key.data_ptr(), counter.data_ptr(), n_steps, n_parts, n_hops,
      out.data_ptr(), dev.index or 0,
      torch.cuda.current_stream(dev).cuda_stream)
  kernels.check(err, 'dist_step_keys')
  with kernels.COUNT_LOCK:
    dist_launches += 1
  return out
