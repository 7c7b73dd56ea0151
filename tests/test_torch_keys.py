"""The port's device-word keys against jax.random, bit for bit.

``random.fold_in`` and ``random.split`` take counts as int64 tensors and
keys as tensors of any leading shape (the form in which an epoch trainer
derives its keys on the card, from a device counter), and
``random.step_keys_plain`` gives a chunk's ``[K, n_hops, 2]`` hop keys.
Each is held to ``jax.random.split(jax.random.fold_in(key, c), n)`` at
counts 0, 1, 2**31 - 1 and 2**32 - 1, over chunks that cross 2**31 and
2**32 (the JAX chunk's int32 ``count0 + start + iota`` wraps there, so
the counts are taken modulo 2**32), for K in {1, 3, 8}.
``csrc/step_keys.cu`` cannot run here: ``_kernel_emulation`` repeats its
steps in numpy uint32 and is held to both. ``ops.step_keys`` on CPU
tensors is the plain version. Every comparison is exact.
"""
import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch import random as trandom

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
U32 = np.uint32
COUNTS = (0, 1, 2 ** 31 - 1, 2 ** 32 - 1)
CHUNKS = ((0, 1), (5, 3), (2 ** 31 - 2, 3), (2 ** 31 - 4, 8),
          (2 ** 32 - 3, 8), (2 ** 32 + 7, 3))


def _threefry(k0, k1, x0, x1):
  """csr_pick.cuh's ``threefry2x32`` on uint32 scalars or arrays."""
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


def _kernel_emulation(base_key, counter, n_steps, n_hops):
  """``step_keys_kernel``, thread by thread: the count of step j is
  ``(counter + j) mod 2**32``; fold_in is threefry(base, (0, count));
  hop h is threefry(folded, (0, h)); words stored as int64."""
  out = np.zeros((n_steps, n_hops, 2), np.int64)
  k0, k1 = (int(w) & 0xFFFFFFFF for w in base_key)
  for i in range(n_steps * n_hops):
    j, h = divmod(i, n_hops)
    x0, x1 = _threefry(k0, k1, 0, (counter + j) & 0xFFFFFFFF)
    y0, y1 = _threefry(int(x0), int(x1), 0, h)
    out[j, h] = int(y0), int(y1)
  return out


def _jax_keys(seed, counts, n_hops):
  key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
  return np.stack([np.asarray(jax.random.split(
      jax.random.fold_in(key, np.uint32(c & 0xFFFFFFFF)), n_hops))
      for c in counts]).astype(np.int64)


def _base(seed):
  return trandom.fold_in(trandom.PRNGKey(seed), 3)


@pytest.mark.parametrize('count', COUNTS)
@pytest.mark.parametrize('n_hops', [1, 3])
def test_fold_in_and_split_on_count_tensors(count, n_hops):
  ref = _jax_keys(11, [count], n_hops)[0]
  base = _base(11)
  for data in (count, torch.tensor(count), torch.tensor([count])):
    key = trandom.fold_in(base, data)
    got = trandom.split(key, n_hops).reshape(n_hops, 2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
  # a batch of keys splits row by row
  keys = trandom.fold_in(base, torch.tensor([count, count + 1]))
  got = trandom.split(keys, n_hops)
  assert got.shape == (2, n_hops, 2)
  np.testing.assert_array_equal(got[0].numpy(), ref)
  np.testing.assert_array_equal(
      got[1].numpy(), _jax_keys(11, [count + 1], n_hops)[0])


@pytest.mark.parametrize('first,n_steps', CHUNKS)
def test_step_keys_plain_and_kernel_emulation_match_jax(first, n_steps):
  counts = [first + j for j in range(n_steps)]
  ref = _jax_keys(5, counts, 3)
  base = _base(5)
  got = trandom.step_keys_plain(
      base, first + torch.arange(n_steps, dtype=torch.int64), 3)
  assert got.shape == (n_steps, 3, 2) and got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), ref)
  np.testing.assert_array_equal(
      _kernel_emulation(base.tolist(), first, n_steps, 3), ref)


@pytest.mark.parametrize('n_steps', [1, 3, 8])
def test_ops_step_keys_on_the_cpu_is_the_plain_version(n_steps):
  ops.reset_launch_counts()
  base = _base(2)
  counter = torch.tensor(2 ** 31 - 2, dtype=torch.int64)
  got = ops.step_keys(base, counter, n_steps, 2)
  want = trandom.step_keys_plain(
      base, counter + torch.arange(n_steps), 2)
  assert torch.equal(got, want)
  np.testing.assert_array_equal(
      got.numpy(), _jax_keys(2, [2 ** 31 - 2 + j for j in range(n_steps)], 2))
  assert ops.launch_counts()['step_keys'] == 0


def test_step_keys_refuses_mixed_devices():
  base = _base(0).to('meta')
  with pytest.raises(ValueError, match='CUDA'):
    ops.step_keys(base, torch.zeros((), dtype=torch.int64), 2, 3)
