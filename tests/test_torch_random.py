"""The port's threefry PRNG against jax.random, bit for bit.

Every sampled id of the port rests on these streams, so the comparison
is exact: key words as integers, uniforms as float32 bit patterns.
"""
import jax
import numpy as np
import pytest

from graphlearn_tpu_torch import random as trandom


def _np(t):
  return t.cpu().numpy()


@pytest.mark.parametrize('seed', [0, 11, 2 ** 31 - 1])
def test_prng_key(seed):
  ref = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
  np.testing.assert_array_equal(_np(trandom.PRNGKey(seed)), ref)


def test_fold_in_counters():
  jkey = jax.random.PRNGKey(7)
  tkey = trandom.PRNGKey(7)
  jfold = jax.jit(jax.vmap(jax.random.fold_in, in_axes=(None, 0)))
  ref = np.asarray(jfold(jkey, np.arange(1001, dtype=np.uint32)))
  got = np.stack([_np(trandom.fold_in(tkey, c)) for c in range(1001)])
  np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize('n', [1, 2, 3, 4])
def test_split(n):
  jkey = jax.random.fold_in(jax.random.PRNGKey(3), 5)
  tkey = trandom.fold_in(trandom.PRNGKey(3), 5)
  ref = np.asarray(jax.random.split(jkey, n)).astype(np.int64)
  np.testing.assert_array_equal(_np(trandom.split(tkey, n)), ref)


@pytest.mark.parametrize('shape', [(1,), (24, 5), (153, 7), (1000, 15)])
def test_uniform(shape):
  jkey = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), 2), 3)[1]
  tkey = trandom.split(trandom.fold_in(trandom.PRNGKey(9), 2), 3)[1]
  ref = np.asarray(jax.random.uniform(jkey, shape))
  got = _np(trandom.uniform(tkey, shape))
  assert got.dtype == np.float32 and got.shape == shape
  # exact: compare the float32 bit patterns
  np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
