"""The float32 uniform draw of the sampling backends, as one launch.

Counterpart of the ``jax.random.uniform(key, shape)`` calls of
``graphlearn_tpu/ops/neighbor.py`` (``weighted_sample``,
``uniform_sample_padded``, ``uniform_sample_block`` and
``build_padded_adjacency_device``). ``uniform`` returns the same float32
words as ``random.uniform``, which is bit-equal to JAX's: on the card
one launch of ``csrc/uniform_draw.cu``, which reads the key from device
memory, so a captured CUDA graph draws from the key its buffer holds at
replay; for a CPU device the plain version, ``random.uniform``. A host
key is uploaded without a host sync (``random.to_device``). Nothing
falls back: a failed build or launch raises.
"""
import math

import torch

from .. import random as trandom
from . import kernels

# launches of the CUDA kernel (plain-version calls do not count)
launches = 0  # graftlint: shared[kernels.COUNT_LOCK]


def uniform(key, shape, device=None) -> torch.Tensor:
  """``jax.random.uniform(key, shape)`` in float32 on ``device`` (default:
  the key's device). ``key`` is a ``[2]`` int64 threefry key, on the host
  or on ``device``: a row of a ``[n, 2]`` batch of keys (``random.split``)
  is fine."""
  key = torch.as_tensor(key)
  device = key.device if device is None else torch.device(device)
  shape = tuple(int(s) for s in shape)
  if device.type == 'cpu':
    return trandom.uniform(key, shape, device)
  if device.type != 'cuda':
    raise ValueError(f'uniform: no kernel for device {device}')
  if device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  if key.device != device:
    if key.device.type != 'cpu':
      raise ValueError(f'uniform: key on {key.device}, draw asked on '
                       f'{device}')
    key = trandom.to_device(key, device)
  if key.dtype != torch.int64 or key.shape != (2,) or \
      not key.is_contiguous():
    raise ValueError(f'uniform: needs a contiguous [2] int64 key, got '
                     f'{tuple(key.shape)} {key.dtype}')
  global launches
  out = torch.empty(shape, dtype=torch.float32, device=device)
  n = math.prod(shape)
  if n == 0:
    return out
  err = kernels.lib('uniform_draw').glt_uniform_draw(
      key.data_ptr(), n, out.data_ptr(), device.index,
      torch.cuda.current_stream(device).cuda_stream)
  kernels.check(err, 'uniform_draw')
  with kernels.COUNT_LOCK:
    launches += 1
  return out
