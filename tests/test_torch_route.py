"""The exchange's routing ops and the partition-local samplers against
the JAX package's, on the CPU.

``round8``, ``exchange_capacity``, ``route_slots`` (with and without the
overflow count), ``scatter_to_buckets``, ``gather_from_buckets`` and
``stitch_rows`` equal JAX's exactly on random routes, on a skewed book
(every id to one part) and on all-masked input. ``uniform_sample_local``
and ``weighted_sample_local`` equal JAX's on a shard's local CSR
(INT32_MAX-padded ``row_ids``), with unowned, masked and padded seeds,
id for id; the uniform one is the fused hop at the found row (K3 on a
card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu import ops as jops
from graphlearn_tpu_torch import ops as tops
from graphlearn_tpu_torch import random as trandom

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max


def _t(a):
  return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('n', [0, 1, 7, 8, 9, 100])
def test_round8(n):
  assert tops.round8(n) == jops.round8(n)


@pytest.mark.parametrize('width,parts,frac,hit', [
    (64, 4, 2.0, 0.0), (64, 4, None, 0.0), (64, 1, 2.0, 0.0),
    (100, 8, 1.5, 0.3), (16, 4, 0.25, 0.0), (24, 2, 2.0, 0.9)])
def test_exchange_capacity(width, parts, frac, hit):
  assert tops.exchange_capacity(width, parts, frac, hit) == \
      jops.exchange_capacity(width, parts, frac, hit)


ROUTES = {
    'random': lambda rng: (rng.integers(0, 4, 40), rng.random(40) < 0.8),
    'skewed': lambda rng: (np.zeros(40, np.int64), np.ones(40, bool)),
    'masked': lambda rng: (rng.integers(0, 4, 40), np.zeros(40, bool)),
}


@pytest.mark.parametrize('route', list(ROUTES))
@pytest.mark.parametrize('cap', [4, 16, 40])
def test_route_scatter_gather_equal_jax(route, cap):
  rng = np.random.default_rng(1)
  dest, mask = ROUTES[route](rng)
  dest = np.where(mask, dest, 4).astype(np.int32)
  vals = rng.integers(0, 1000, 40).astype(np.int32)
  rows = rng.standard_normal((40, 3)).astype(np.float32)
  js, jok, jov = jops.route_slots(jnp.asarray(dest), jnp.asarray(mask),
                                  capacity=cap, with_overflow=True)
  ts, tok, tov = tops.route_slots(_t(dest), _t(mask), cap,
                                  with_overflow=True)
  np.testing.assert_array_equal(np.asarray(js), ts.numpy())
  np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
  assert int(jov) == int(tov) and tov.dtype == torch.int32
  ts2, tok2 = tops.route_slots(_t(dest), _t(mask), cap)
  assert torch.equal(ts2, ts) and torch.equal(tok2, tok)
  for v in (vals, rows):
    jb = jops.scatter_to_buckets(jnp.asarray(v), jnp.asarray(dest), js,
                                 jok, 4, cap)
    tb = tops.scatter_to_buckets(_t(v), _t(dest), ts, tok, 4, cap)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    for fill in (jops.FILL, 0):
      jg = jops.gather_from_buckets(jb, jnp.asarray(dest), js, jok,
                                    fill=fill)
      tg = tops.gather_from_buckets(tb, _t(dest), ts, tok, fill=fill)
      np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
  # a boolean payload, gathered with a False fill (the sampler's masks)
  bm = rng.random((4, cap, 2)) < 0.5
  np.testing.assert_array_equal(
      np.asarray(jops.gather_from_buckets(jnp.asarray(bm),
                                          jnp.asarray(dest), js, jok,
                                          fill=False)),
      tops.gather_from_buckets(_t(bm), _t(dest), ts, tok, fill=False)
      .numpy())


def test_stitch_rows_equals_jax():
  rng = np.random.default_rng(2)
  idx = [np.array([2, 0, 5, 1]), np.array([3, 4, 9, -2])]
  rows = [rng.integers(0, 9, (4, 3)).astype(np.int32) for _ in range(2)]
  masks = [rng.random((4, 3)) < 0.6 for _ in range(2)]
  masks[1][2] = False          # a padded row (its position is arbitrary)
  jo, jm = jops.stitch_rows([jnp.asarray(i) for i in idx],
                            [jnp.asarray(r) for r in rows],
                            [jnp.asarray(m) for m in masks], 6)
  to, tm = tops.stitch_rows([_t(i) for i in idx], [_t(r) for r in rows],
                            [_t(m) for m in masks], 6)
  np.testing.assert_array_equal(np.asarray(jo), to.numpy())
  np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def _local_csr(seed=0, n=60, own=0.5):
  """A shard's local CSR over a random subset of ``n`` nodes: owned ids
  ascending, padded to 48 rows with INT32_MAX; dyadic weights."""
  rng = np.random.default_rng(seed)
  owned = np.sort(rng.choice(n, int(n * own), replace=False))
  deg = rng.integers(0, 7, owned.shape[0])
  deg[:3] = (0, 12, 1)
  row_ids = np.full(48, INT32_MAX, np.int32)
  row_ids[:owned.shape[0]] = owned
  indptr = np.zeros(49, np.int32)
  indptr[1:owned.shape[0] + 1] = np.cumsum(deg)
  indptr[owned.shape[0] + 1:] = indptr[owned.shape[0]]
  e = int(deg.sum())
  indices = rng.integers(0, n, e + 5).astype(np.int32)
  indices[e:] = -1
  w = (rng.integers(1, 9, e + 5) / 4).astype(np.float32)
  cum = gtt.ops.build_row_cumsum(indptr, w[:e])
  wcum = np.zeros(e + 5, np.float32)
  wcum[:e] = cum
  seeds = np.concatenate([owned[:10], rng.integers(0, n, 10),
                          [-1, n + 5]]).astype(np.int32)
  mask = np.ones(seeds.shape[0], bool)
  mask[[1, 7]] = False
  return row_ids, indptr, indices, wcum, seeds, mask


@pytest.mark.parametrize('k', [1, 4])
@pytest.mark.parametrize('seed', [0, 1])
def test_uniform_sample_local_equals_jax(k, seed):
  row_ids, indptr, indices, _, seeds, mask = _local_csr(seed)
  key = jax.random.fold_in(jax.random.PRNGKey(3), seed)
  jo = jops.uniform_sample_local(*(jnp.asarray(a) for a in (
      row_ids, indptr, indices, seeds, mask)), k, key)
  tkey = trandom.fold_in(trandom.PRNGKey(3), seed)
  to = tops.uniform_sample_local(*(_t(a) for a in (
      row_ids, indptr, indices, seeds, mask)), k, tkey)
  for a, b in zip(jo, to):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
  # unowned or masked seeds come back masked
  owned = np.isin(seeds, row_ids) & mask
  assert not to[2].numpy()[~owned].any()


@pytest.mark.parametrize('k', [2, 5])
def test_weighted_sample_local_equals_jax(k):
  row_ids, indptr, indices, wcum, seeds, mask = _local_csr(2)
  key = jax.random.PRNGKey(7)
  jo = jops.weighted_sample_local(*(jnp.asarray(a) for a in (
      row_ids, indptr, indices, wcum, seeds, mask)), k, key)
  to = tops.weighted_sample_local(*(_t(a) for a in (
      row_ids, indptr, indices, wcum, seeds, mask)), k,
      trandom.PRNGKey(7))
  for a, b in zip(jo, to):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_searchsorted_membership_and_collate_helpers_equal_jax():
  vals = np.array([1, 4, 4, 9, INT32_MAX, INT32_MAX], np.int32)
  q = np.array([0, 1, 4, 5, 9, 10, INT32_MAX - 1], np.int32)
  jf, jp = jops.searchsorted_membership(jnp.asarray(vals), jnp.asarray(q))
  tf, tp = tops.searchsorted_membership(_t(vals), _t(q))
  np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
  np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
  a, b = np.arange(6).reshape(2, 3), np.arange(6, 12).reshape(2, 3)
  np.testing.assert_array_equal(np.asarray(jops.stack2_batched(a, b)),
                                tops.stack2_batched(_t(a), _t(b)).numpy())
  np.testing.assert_array_equal(np.asarray(jops.stack2(a[0], b[0])),
                                tops.stack2(_t(a[0]), _t(b[0])).numpy())
  np.testing.assert_array_equal(
      np.asarray(jops.valid_mask(jnp.zeros(5), 3)),
      tops.valid_mask(torch.zeros(5), 3).numpy())
