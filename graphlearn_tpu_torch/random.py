"""Counter-based threefry2x32 PRNG, bit-exact with ``jax.random``.

The JAX package addresses every sampling draw by a threefry key: the
sampler folds a host call counter into its base key
(``sampler/neighbor_sampler.py:_next_key``), splits one key per hop, and
draws float32 uniforms per fanout slot. Reproducing those bits in torch
is what lets every id, mask and count of the port equal the JAX
package's, so this module implements the subset the main path uses with
the counter layout of ``jax_threefry_partitionable=True`` (the default
since jax 0.5):

  PRNGKey(seed)       -> [0, seed mod 2**32]           (threefry_seed)
  fold_in(key, d)     -> threefry(key, (0, d))          (_threefry_fold_in)
  split(key, n)[i]    -> threefry(key, (hi(i), lo(i)))  (iota_2x32_shape)
  uniform(key, shape) -> mantissa of bits1 ^ bits2 at flat index i
  randint(key, shape, lo, hi) -> two words per value, reduced in uint32
  permutation(key, n) -> stable sorts of arange(n) by fresh words  (_shuffle)

Torch has no full uint32 arithmetic, so words live in int64 tensors and
are masked to 32 bits after every add and rotate. Keys are ``[..., 2]``
int64 tensors holding the two uint32 words. ``fold_in`` and ``split``
take a key on the CPU or on a device and a step count as a Python int or
an int64 tensor, and run where the key or the count lies without reading
a device value back: ``step_keys_plain`` derives a chunk's hop keys from
a device counter this way, and ``to_device`` uploads a host key without
a host sync. ``random_bits``, ``uniform`` and ``permutation`` run on the
caller's device and take a key on the CPU or on that device. This is the
plain version of the draw: the sampling kernels (``csrc/csr_pick.cuh``)
run the same threefry inside the kernel, and ``csrc/step_keys.cu`` the
fold_in and split of ``step_keys_plain`` and ``dist_step_keys_plain``.
"""
import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
  return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
  """Threefry-2x32 (20 rounds) of the count words ``x0``/``x1`` (int64
  tensors of uint32 values) under the key ``(k1, k2)`` (ints, or int64
  tensors that broadcast with the counts); returns the two
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
  """The key's two words: Python ints for a ``[2]`` host key, int64
  tensors of the key's leading shape otherwise (read where the key lies,
  without a host sync)."""
  key = torch.as_tensor(key)
  if key.dim() == 0 or key.shape[-1] != 2:
    raise ValueError(f'a threefry key has 2 words, got shape '
                     f'{tuple(key.shape)}')
  if key.device.type == 'cpu' and key.dim() == 1:
    k = [int(v) for v in key.tolist()]
    return k[0] & _MASK, k[1] & _MASK
  key = key.to(torch.int64)
  return key[..., 0] & _MASK, key[..., 1] & _MASK


def to_device(keys, device):
  """Host keys (``[2]`` or ``[n, 2]`` int64) on ``device``: on a card,
  one copy from pinned memory that does not block the host."""
  device = torch.device(device)
  keys = torch.as_tensor(keys, dtype=torch.int64)
  if keys.device == device or device.type != 'cuda':
    return keys.to(device)
  if keys.device.type == 'cpu':
    keys = keys.pin_memory()
  return keys.to(device, non_blocking=True)


def PRNGKey(seed: int):
  """``jax.random.PRNGKey(seed)`` as JAX computes it without 64-bit mode
  (the JAX package's setting): an int64 seed is cast to int32, so the
  key is ``[0, seed mod 2**32]``. Folded seeds outgrow 32 bits (the
  remote loaders' ``seed * 7919 + i``, then ``* 1000003 + rank``)."""
  seed = int(seed)
  if not -2 ** 63 <= seed < 2 ** 63:
    raise ValueError(f'seed {seed} outside the int64 range')
  return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(key, data):
  """``jax.random.fold_in(key, data)``: ``data`` is a Python int or an
  int64 tensor (0-d or 1-d, taken modulo 2**32 as jax's uint32 cast
  does); a ``[2]`` key and a ``[K]`` count give ``[K, 2]`` keys, a
  ``[K, 2]`` key folds each row with its count."""
  k1, k2 = _words(key)
  if torch.is_tensor(data):
    x1 = data.to(torch.int64) & _MASK
  else:
    dev = k1.device if torch.is_tensor(k1) else None
    x1 = torch.tensor(int(data) & _MASK, dtype=torch.int64, device=dev)
  y0, y1 = threefry2x32(k1, k2, torch.zeros_like(x1), x1)
  return torch.stack([y0, y1], -1)


def split(key, num: int = 2):
  """``jax.random.split(key, num)``: a ``[2]`` key gives ``[num, 2]``
  keys, a ``[..., 2]`` batch of keys ``[..., num, 2]``."""
  k1, k2 = _words(key)
  dev = k1.device if torch.is_tensor(k1) else None
  if torch.is_tensor(k1):
    k1, k2 = k1[..., None], k2[..., None]
  idx = torch.arange(num, dtype=torch.int64, device=dev)
  y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
  return torch.stack([y0, y1], -1)


def step_keys_plain(base_key, counts, n_hops: int):
  """The hop keys of a chunk of steps: ``[K, n_hops, 2]`` words of
  ``split(fold_in(base_key, counts[j]), n_hops)``, in torch ops on the
  counts' device (``counts``: ``[K]`` int64, each taken modulo 2**32, as
  the JAX chunk's int32 ``count0 + start + iota`` wraps). The plain
  version of ``csrc/step_keys.cu``."""
  counts = torch.as_tensor(counts, dtype=torch.int64)
  base_key = torch.as_tensor(base_key, dtype=torch.int64)
  if base_key.device != counts.device:
    base_key = to_device(base_key, counts.device)
  return split(fold_in(base_key, counts), n_hops)


def dist_step_keys_plain(base_key, counts, n_parts: int, n_hops: int):
  """The keys of a distributed chunk: ``[K, n_parts, n_hops, 2]`` words of
  ``split(split(fold_in(base_key, counts[j]), n_parts)[p], n_hops)[h]``
  (JAX's dist chunk draws ``split(fold_in(base_key, count), P)[shard]``
  per step and the shard's hop loop splits it per hop), in torch ops on
  the counts' device. The plain version of ``csrc/step_keys.cu``'s
  ``glt_dist_step_keys``."""
  counts = torch.as_tensor(counts, dtype=torch.int64)
  base_key = torch.as_tensor(base_key, dtype=torch.int64)
  if base_key.device != counts.device:
    base_key = to_device(base_key, counts.device)
  return split(split(fold_in(base_key, counts), n_parts), n_hops)


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


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(key, shape, minval: int, maxval: int, device=None):
  """``jax.random.randint(key, shape, minval, maxval)`` for int32, bit for
  bit, on ``device`` (the key on the CPU or on that device).

  JAX splits the key in two (``higher``, ``lower``), draws one 32-bit
  word per value from each and reduces them to ``[minval, maxval)`` in
  uint32 arithmetic: ``multiplier = (2**16 % span)**2 % span`` and
  ``((hi % span) * multiplier + lo % span) % span``, where every product
  and sum wraps mod 2**32. From span 65,536 on ``2**16 % span`` squared
  wraps to 0 and the value is ``lo % span``: int64 arithmetic without the
  wrap would agree with JAX on no larger span. So every uint32 step here
  is masked to 32 bits."""
  shape = tuple(int(s) for s in shape)
  lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
  hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
  span = (hi_v - lo_v) & _MASK if hi_v > lo_v else 1
  mult = ((2 ** 16 % span) ** 2 & _MASK) % span   # 0 from span 65,537
  k_hi, k_lo = split(key)
  higher = random_bits(k_hi, shape, device)
  lower = random_bits(k_lo, shape, device)
  off = (((higher % span) * mult & _MASK) + lower % span) & _MASK
  val = (lo_v + off % span) & _MASK      # the int32 add wraps
  return (((val + 2 ** 31) & _MASK) - 2 ** 31).to(torch.int32)


def permutation(key, n: int, device=None):
  """``jax.random.permutation(key, n)`` for an integer ``n``: a shuffle of
  ``arange(n)`` (int32) on ``device``, bit-equal to jax's ``_shuffle``.

  Each of ``ceil(3 ln(max(1, n)) / ln(2**32 - 1))`` rounds splits the key
  (``key, subkey = split(key)``), draws one 32-bit word per element from
  the subkey and stably sorts the values by those words. The words are
  uint32 values held in int64, so they sort as unsigned: sorted as int32
  their high half would turn negative and change the order."""
  n = int(n)
  x = torch.arange(n, dtype=torch.int32, device=device)
  rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
  for _ in range(rounds):
    key, subkey = split(key)
    words = random_bits(subkey, (n,), device)
    order = torch.sort(words, stable=True).indices
    x = x[order]
  return x
