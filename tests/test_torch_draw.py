"""The sampling kernels' in-kernel draw, emulated in numpy, against the
JAX package's ``_draw`` (``graphlearn_tpu/ops/sample_fused.py``).

The CUDA kernels (``graphlearn_tpu_torch/csrc/csr_pick.cuh``) cannot run
here, so this file repeats their arithmetic step for step in numpy uint32
and float32 (round to nearest even, as ``__int2float_rn``, ``__fmul_rn``
and ``__fsub_rn`` do) and holds it to the reference. ``SPEC`` below is the
kernel header's own comment; a test checks that the header still says it.
Every comparison is exact.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from graphlearn_tpu.ops import sample_fused as jsf
from graphlearn_tpu_torch import random as trandom
from graphlearn_tpu_torch.ops import neighbor

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

HEADER = (Path(__file__).resolve().parents[1] / 'graphlearn_tpu_torch' /
          'csrc' / 'csr_pick.cuh')
SPEC = """\
slot (b, j) of a [B, k] hop takes the flat counter i = b * k + j as the
two words (hi, lo) = (i >> 32, i & 0xFFFFFFFF), the partitionable layout
of jax.random; (y0, y1) = threefry2x32(key, (hi, lo)), 20 rounds, and
bits = y0 ^ y1; u = float_from_bits((bits >> 9) | 0x3F800000) - 1.0f;
rand_off = floor(u * float(deg)), clamped to deg - 1; the offset is
rand_off when deg > k and j otherwise; the slot is valid when its seed
is and offset < deg, and its edge position is start + offset.
float(deg) rounds to nearest even (__int2float_rn), and so do the
product (__fmul_rn) and the subtraction (__fsub_rn): no fast math."""
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
DEGS = (0, 1, 5, 6, 2 ** 24 - 1, 2 ** 24 + 1, 2 ** 31 - 1)   # k = 5
U32 = np.uint32


def threefry(k0, k1, x0, x1):
  """threefry2x32, 20 rounds, on uint32 arrays (csr_pick.cuh's
  ``threefry2x32``)."""
  k0, k1 = U32(k0), U32(k1)
  x0, x1 = np.asarray(x0, U32), np.asarray(x1, U32)
  ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
  with np.errstate(over='ignore'):
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
      for r in ROT[g % 2]:
        x0 = x0 + x1
        x1 = (x1 << U32(r)) | (x1 >> U32(32 - r))
        x1 = x1 ^ x0
      x0 = x0 + ks[(g + 1) % 3]
      x1 = x1 + ks[(g + 2) % 3] + U32(g + 1)
  return x0, x1


def uniform_offset(bits, deg):
  """``uniform_offset``: u from the top 23 bits, floor(u * float(deg)) in
  float32, clamped to max(deg - 1, 0)."""
  u = (((np.asarray(bits, U32) >> U32(9)) | U32(0x3F800000))
       .view(np.float32) - np.float32(1.0))
  off = np.floor(u * np.asarray(deg).astype(np.float32)).astype(np.int64)
  return np.minimum(off, np.maximum(np.asarray(deg, np.int64) - 1, 0))


def draw(key, start, deg, seed_mask, k):
  """The kernel's ``(safe_epos, mask)`` of a ``[B, k]`` hop."""
  k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
  b = start.shape[0]
  i = np.arange(b * k, dtype=np.uint64).reshape(b, k)
  y0, y1 = threefry(k0, k1, (i >> np.uint64(32)).astype(U32),
                    (i & np.uint64(0xFFFFFFFF)).astype(U32))
  j = np.arange(k)[None, :]
  d = deg.astype(np.int64)[:, None]
  off = np.where(d > k, uniform_offset(y0 ^ y1, d), j)
  valid = seed_mask[:, None] & (off < d)
  return np.where(valid, start.astype(np.int64)[:, None] + off, 0), valid


def _keys():
  return [(0, 0), (0, 42), (0xDEADBEEF, 0x12345678),
          tuple(int(w) for w in trandom.fold_in(trandom.PRNGKey(7), 3))]


def test_header_states_the_spec():
  text = HEADER.read_text()
  lines = text[text.index('// The draw'):].splitlines()[1:]
  body = []
  for line in lines:
    if line.strip() == '//':
      break
    body.append(line[2:].strip())
  assert body == [line.strip() for line in SPEC.splitlines()]


@pytest.mark.parametrize('key', _keys())
def test_draw_matches_jax(key):
  """Every listed degree (0, 1, k, k + 1, 2^24 - 1, 2^24 + 1, 2^31 - 1)
  and random ones, masked seeds, under several keys: the emulation's
  edge positions and mask equal JAX's ``_draw`` and the port's plain
  draw."""
  rng = np.random.default_rng(key[1] & 0xFFFF)
  k = 5
  deg = np.concatenate([np.repeat(DEGS, 9),
                        rng.integers(0, 40, 300)]).astype(np.int32)
  start = np.where(deg > 2 ** 20, 0, rng.integers(0, 10_000, deg.size))
  start = start.astype(np.int32)
  seed_mask = rng.random(deg.size) < 0.9
  got_epos, got_mask = draw(key, start, deg, seed_mask, k)
  jkey = jnp.asarray(key, jnp.uint32)
  jepos, jmask = jsf._draw(jnp.asarray(start), jnp.asarray(deg),
                           jnp.asarray(seed_mask), k, jkey)
  np.testing.assert_array_equal(got_mask, np.asarray(jmask))
  np.testing.assert_array_equal(got_epos,
                                np.where(jmask, np.asarray(jepos), 0))
  tkey = torch.tensor(key, dtype=torch.int64)
  tepos, tmask = neighbor._draw(torch.as_tensor(start),
                                torch.as_tensor(deg),
                                torch.as_tensor(seed_mask), k, tkey)
  np.testing.assert_array_equal(got_mask, tmask.numpy())
  np.testing.assert_array_equal(got_epos,
                                torch.where(tmask, tepos, 0).numpy())


@pytest.mark.parametrize('key', _keys())
def test_counter_words_past_2_32(key):
  """Counter words fed directly, hi != 0 included: the emulation's
  threefry equals jax's ``threefry2x32`` primitive and the port's
  ``random.threefry2x32``; with hi = 0 its bits are
  ``random.random_bits``' own layout."""
  rng = np.random.default_rng(5)
  hi = np.concatenate([[0, 1, 2, 0xFFFFFFFF], rng.integers(0, 2 ** 32, 60)])
  lo = np.concatenate([[0, 7, 0xFFFFFFFF, 3], rng.integers(0, 2 ** 32, 60)])
  hi, lo = hi.astype(U32), lo.astype(U32)
  y0, y1 = threefry(key[0], key[1], hi, lo)
  j0, j1 = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                     jnp.asarray(hi), jnp.asarray(lo))
  np.testing.assert_array_equal(y0, np.asarray(j0))
  np.testing.assert_array_equal(y1, np.asarray(j1))
  t0, t1 = trandom.threefry2x32(key[0], key[1],
                                torch.as_tensor(hi.astype(np.int64)),
                                torch.as_tensor(lo.astype(np.int64)))
  np.testing.assert_array_equal(y0, t0.numpy().astype(U32))
  np.testing.assert_array_equal(y1, t1.numpy().astype(U32))
  b0, b1 = threefry(key[0], key[1], np.zeros(12, U32), np.arange(12))
  bits = trandom.random_bits(torch.tensor(key, dtype=torch.int64), (3, 4))
  np.testing.assert_array_equal((b0 ^ b1).reshape(3, 4),
                                bits.numpy().astype(U32))


@pytest.mark.parametrize('deg', DEGS[3:])
def test_offset_at_the_top_of_u(deg):
  """The largest, smallest and middle bits at each degree above k: the
  emulation equals the plain draw's torch arithmetic on the same u. At the
  top of u's range (1 - 2^-23) floor(u * float(deg)) stays at or below
  deg - 1 even where float(deg) is not deg (2^24 + 1 rounds down, 2^31 - 1
  up), so the clamp to deg - 1 changes no offset: it is the reference's
  guard, kept in the kernel."""
  bits = np.array([0xFFFFFFFF, 0xFFFFFE00, 0, 0x80000000, 0x7FFFFFFF], U32)
  got = uniform_offset(bits, np.full(bits.size, deg))
  u = torch.as_tensor(((bits >> U32(9)) | U32(0x3F800000)).view(np.float32)
                      - np.float32(1.0))
  d = torch.full((bits.size,), deg, dtype=torch.int32)
  ref = torch.minimum(torch.floor(u * d.to(torch.float32)).to(torch.int64),
                      torch.clamp(d.long() - 1, min=0))
  np.testing.assert_array_equal(got, ref.numpy())
  raw = np.floor(np.float32(1 - 2 ** -23) * np.float32(deg))
  assert got[0] == raw <= deg - 1
