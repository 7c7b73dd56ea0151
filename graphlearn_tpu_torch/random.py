"""Counter-based threefry2x32 PRNG, bit-exact with ``jax.random``.

The JAX package addresses every sampling draw by a threefry key: the
sampler folds a host call counter into its base key
(``sampler/neighbor_sampler.py:_next_key``), splits one key per hop, and
draws float32 uniforms per fanout slot. Reproducing those bits in torch
is what lets every id, mask and count of the port equal the JAX
package's, so this module implements the subset the main path uses with
the counter layout of ``jax_threefry_partitionable=True`` (the default
since jax 0.5):

  PRNGKey(seed)       -> [0, seed]                     (threefry_seed)
  fold_in(key, d)     -> threefry(key, (0, d))          (_threefry_fold_in)
  split(key, n)[i]    -> threefry(key, (hi(i), lo(i)))  (iota_2x32_shape)
  uniform(key, shape) -> mantissa of bits1 ^ bits2 at flat index i

Torch has no full uint32 arithmetic, so words live in int64 tensors and
are masked to 32 bits after every add and rotate. Keys are ``[2]`` int64
tensors holding the two uint32 words; they stay on the CPU (deriving a
key is a handful of scalar ops), and only ``uniform`` runs on the
caller's device. This is plain torch, not a kernel: in the JAX package
the draw also lies outside the Pallas kernels.
"""
import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
  return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x0, x1):
  """Threefry-2x32 (20 rounds) of the count words ``x0``/``x1`` (int64
  tensors of uint32 values) under the key ``(k1, k2)``; returns the two
  output words. Same round schedule as jax's ``_threefry2x32_lowering``."""
  ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
  x0 = (x0 + ks[0]) & _MASK
  x1 = (x1 + ks[1]) & _MASK
  for i in range(5):
    for r in _ROT[i % 2]:
      x0 = (x0 + x1) & _MASK
      x1 = _rotl(x1, r) ^ x0
    x0 = (x0 + ks[(i + 1) % 3]) & _MASK
    x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
  return x0, x1


def _words(key):
  k = [int(v) for v in torch.as_tensor(key).reshape(-1).tolist()]
  if len(k) != 2:
    raise ValueError(f'a threefry key has 2 words, got {len(k)}')
  return k[0] & _MASK, k[1] & _MASK


def PRNGKey(seed: int):
  """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
  seed = int(seed)
  if not 0 <= seed <= _MASK:
    raise ValueError(f'seed {seed} outside [0, 2**32)')
  return torch.tensor([0, seed], dtype=torch.int64)


def fold_in(key, data: int):
  """``jax.random.fold_in(key, data)``."""
  k1, k2 = _words(key)
  x0 = torch.zeros(1, dtype=torch.int64)
  x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
  y0, y1 = threefry2x32(k1, k2, x0, x1)
  return torch.cat([y0, y1])


def split(key, num: int = 2):
  """``jax.random.split(key, num)`` -> ``[num, 2]`` keys."""
  k1, k2 = _words(key)
  idx = torch.arange(num, dtype=torch.int64)
  y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
  return torch.stack([y0, y1], dim=1)


def random_bits(key, shape, device=None):
  """``jax.random.bits(key, shape)`` for 32-bit words, as int64 values."""
  k1, k2 = _words(key)
  n = math.prod(shape)
  idx = torch.arange(n, dtype=torch.int64, device=device)
  y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
  return (y0 ^ y1).reshape(shape)


def uniform(key, shape, device=None):
  """``jax.random.uniform(key, shape)`` in float32 on ``device``: the top
  23 bits become the mantissa of a float in [1, 2), minus one."""
  bits = random_bits(key, tuple(shape), device)
  fbits = (bits >> 9) | 0x3F800000
  return fbits.to(torch.int32).view(torch.float32) - 1.0
