"""The port's padded, block and weighted sampling ops against the JAX
package's, on the CPU.

Graphs, seeds, masks and weights come from numpy with a seed; keys are
the same threefry words in both packages. Every nbrs, epos and mask is
compared exactly, on graphs with the edge cases of
tests/test_neighbor_sampler.py and tests/test_ops.py: degree-0 rows, rows
with deg <= k (keep-all), hub rows, rows straddling a 16-wide block, rows
in the last block, masked seeds and the boundary id N-1.
``build_row_cumsum`` is held against JAX's on dyadic weights (both CDFs
exact) and against numpy's float64 row CDF everywhere; past a running
total of 2**24 JAX's float32 CDF loses whole weights and the port's does
not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu import ops as jops
from graphlearn_tpu_torch import ops as tops
from graphlearn_tpu_torch import random as trandom

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _t(a):
  return torch.as_tensor(np.asarray(a))


def _eq(a, b):
  np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _keys(trial):
  return (jax.random.fold_in(jax.random.PRNGKey(5), trial),
          trandom.fold_in(trandom.PRNGKey(5), trial))


def _graph(seed, n=90, e=1200, hub_deg=200):
  """A CSR with a hub (row 1), degree-0 rows (2 and N-1), rows of degree
  1-16 placed to straddle 16-wide blocks, and a short last row ending in
  the last, partial block."""
  rng = np.random.default_rng(seed)
  rows = [np.full(hub_deg, 1)]
  for r, d in ((3, 5), (4, 13), (5, 16), (6, 17), (7, 1), (8, 15)):
    rows.append(np.full(d, r))
  rows.append(rng.integers(9, n - 2, e))
  rows.append(np.full(3, n - 2))
  rows = np.concatenate(rows)
  cols = rng.integers(0, n, rows.shape[0])
  order = np.argsort(rows, kind='stable')
  rows, cols = rows[order], cols[order]
  indptr = np.concatenate(
      [[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int32)
  return indptr, cols.astype(np.int32), rng


def _seeds(rng, n, b):
  seeds = np.concatenate([[1, 2, 3, 4, 5, 6, 7, 8, n - 1, n - 2, 0],
                          rng.integers(0, n, b - 11)]).astype(np.int32)
  mask = rng.random(b) < 0.85
  mask[:10] = True
  return seeds, mask


@pytest.mark.parametrize('k', [1, 5, 15])
@pytest.mark.parametrize('window', [16, 64])
def test_uniform_sample_padded_matches_jax(k, window):
  ip, ind, rng = _graph(k * 7 + window)
  n = ip.shape[0] - 1
  seeds, mask = _seeds(rng, n, 48)
  jkey, tkey = _keys(k + window)
  jt = jops.build_padded_adjacency_device(jnp.asarray(ip), jnp.asarray(ind),
                                          window, jkey, edge_pos=True)
  tt = tops.build_padded_adjacency_device(_t(ip), _t(ind), window, tkey,
                                          edge_pos=True)
  for a, b in zip(jt, tt):
    _eq(a, b)
  for trial, ep in ((0, True), (1, False)):
    jkey, tkey = _keys(100 + trial)
    ref = jops.uniform_sample_padded(
        jt[0], jt[1], jnp.asarray(seeds), jnp.asarray(mask), k, jkey,
        epos_table=jt[2] if ep else None)
    got = tops.uniform_sample_padded(
        tt[0], tt[1], _t(seeds), _t(mask), k, tkey,
        epos_table=tt[2] if ep else None)
    for a, b in zip(ref, got):
      _eq(a, b)


@pytest.mark.parametrize('k', [1, 4, 10, 16])
def test_uniform_sample_block_matches_jax(k):
  ip, ind, rng = _graph(40 + k)
  n = ip.shape[0] - 1
  e = ind.shape[0]
  blocks = np.concatenate([ind, np.full((-e) % 16, -1, np.int32)]
                          ).reshape(-1, 16)
  meta = np.stack([ip[:-1], ip[1:] - ip[:-1]], 1).astype(np.int32)
  seeds, mask = _seeds(rng, n, 64)
  for trial in range(3):
    jkey, tkey = _keys(trial)
    ref = jops.uniform_sample_block(jnp.asarray(meta), jnp.asarray(blocks),
                                    e, jnp.asarray(seeds),
                                    jnp.asarray(mask), k, jkey)
    got = tops.uniform_sample_block(_t(meta), _t(blocks), e, _t(seeds),
                                    _t(mask), k, tkey)
    for a, b in zip(ref, got):
      _eq(a, b)


def test_uniform_sample_block_last_block_and_all_masked():
  # every edge in one partial last block; a degree-0 row at its end
  ip = np.array([0, 3, 9, 9], np.int32)
  ind = np.arange(9, dtype=np.int32)
  blocks = np.concatenate([ind, np.full(7, -1, np.int32)]).reshape(-1, 16)
  meta = np.stack([ip[:-1], ip[1:] - ip[:-1]], 1).astype(np.int32)
  jkey, tkey = _keys(9)
  for mask in (np.array([True, True, True, True]),
               np.zeros(4, bool)):
    seeds = np.array([0, 1, 2, 1], np.int32)
    for k in (2, 4):
      ref = jops.uniform_sample_block(jnp.asarray(meta), jnp.asarray(blocks),
                                      9, jnp.asarray(seeds),
                                      jnp.asarray(mask), k, jkey)
      got = tops.uniform_sample_block(_t(meta), _t(blocks), 9, _t(seeds),
                                      _t(mask), k, tkey)
      for a, b in zip(ref, got):
        _eq(a, b)


@pytest.mark.parametrize('k', [1, 5, 12])
def test_weighted_sample_matches_jax(k):
  ip, ind, rng = _graph(70 + k)
  n = ip.shape[0] - 1
  # dyadic weights with a small total: JAX's float32 CDF is exact
  w = (rng.integers(1, 32, ind.shape[0]) / 8).astype(np.float32)
  jcum = jops.build_row_cumsum(jnp.asarray(ip), jnp.asarray(w))
  tcum = tops.build_row_cumsum(ip, w)
  np.testing.assert_array_equal(np.asarray(jcum), tcum)
  seeds, mask = _seeds(rng, n, 48)
  for trial in range(2):
    jkey, tkey = _keys(trial)
    ref = jops.weighted_sample(jnp.asarray(ip), jnp.asarray(ind), jcum,
                               jnp.asarray(seeds), jnp.asarray(mask), k, jkey)
    got = tops.weighted_sample(_t(ip), _t(ind), _t(tcum), _t(seeds),
                               _t(mask), k, tkey)
    for a, b in zip(ref, got):
      _eq(a, b)


def test_weighted_sample_zero_weight_edges_never_drawn():
  ip = np.array([0, 40], np.int32)
  ind = np.arange(40, dtype=np.int32)
  w = np.zeros(40, np.float32)
  w[[3, 17, 29]] = [1.0, 2.0, 0.5]
  cum = _t(tops.build_row_cumsum(ip, w))
  for trial in range(4):
    _, tkey = _keys(trial)
    nbrs, _, mask = tops.weighted_sample(
        _t(ip), _t(ind), cum, _t(np.zeros(64, np.int32)),
        _t(np.ones(64, bool)), 8, tkey)
    assert bool(mask.all())
    assert set(nbrs.unique().tolist()) <= {3, 17, 29}


def _row_cdf64(indptr, w):
  out = np.empty(w.shape[0], np.float64)
  for r in range(indptr.shape[0] - 1):
    s, e = indptr[r], indptr[r + 1]
    out[s:e] = np.cumsum(w[s:e].astype(np.float64))
  return out.astype(np.float32)


@pytest.mark.parametrize('split', [1024, 4])
def test_build_row_cumsum_equals_numpy_float64_row_cdf(monkeypatch, split):
  # arbitrary (non-dyadic) weights, a hub row longer than the split, and
  # a split of 4 so the long-row path covers most rows
  monkeypatch.setattr(tops.neighbor, '_CDF_ROW_SPLIT', split)
  ip, _, rng = _graph(11, hub_deg=3000)
  w = rng.random(ip[-1]).astype(np.float32) * 1e3
  np.testing.assert_array_equal(tops.build_row_cumsum(ip, w),
                                _row_cdf64(ip, w))


def test_row_cumsum_past_2_24_jax_loses_weights_port_does_not():
  big = 2 ** 24
  ip = np.array([0, big, big + 64], np.int64)
  w = np.ones(big + 64, np.float32)
  port = tops.build_row_cumsum(ip, w)
  np.testing.assert_array_equal(port[big:], np.arange(1, 65, dtype=np.float32))
  jcum = np.asarray(jops.build_row_cumsum(jnp.asarray(ip.astype(np.int32)),
                                          jnp.asarray(w)))
  # the reference's float32 running total stops adding whole weights:
  # the second row's CDF is not 1, 2, 3, ... and its first edge reads 0
  assert not np.array_equal(jcum[big:], port[big:])
  assert jcum[big] == 0.0


def _tied_graph():
  """One row of 8192 edges, whose draws under this key tie (float32
  draws carry 23 random bits), plus small rows."""
  rng = np.random.default_rng(2)
  rows = np.concatenate([np.zeros(8192, np.int64),
                         rng.integers(1, 30, 400)])
  rows.sort(kind='stable')
  cols = rng.integers(0, 30, rows.shape[0]).astype(np.int32)
  ip = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=30))]
                      ).astype(np.int32)
  return ip, cols


@pytest.mark.parametrize('edge_pos', [False, True])
def test_build_padded_adjacency_device_matches_jax_with_ties(edge_pos):
  ip, ind = _tied_graph()
  jkey, tkey = _keys(3)
  draws = trandom.uniform(tkey, (ind.shape[0],)).numpy()[:8192]
  assert np.unique(draws).shape[0] < 8192, 'no tie in the hub row'
  for window in (16, 8192):
    ref = jops.build_padded_adjacency_device(jnp.asarray(ip), jnp.asarray(ind),
                                             window, jkey, edge_pos=edge_pos)
    got = tops.build_padded_adjacency_device(_t(ip), _t(ind), window, tkey,
                                             edge_pos=edge_pos)
    for a, b in zip(ref, got):
      if a is None:
        assert b is None
      else:
        _eq(a, b)


@pytest.mark.parametrize('edge_pos', [False, True])
@pytest.mark.parametrize('seed', [0, 3])
def test_build_padded_adjacency_host_matches_jax(edge_pos, seed):
  ip, ind, _ = _graph(seed)
  for window in (4, 16):
    ref = jops.build_padded_adjacency(ip, ind, window, seed=seed,
                                      edge_pos=edge_pos)
    got = tops.build_padded_adjacency(ip, ind, window, seed=seed,
                                      edge_pos=edge_pos)
    for a, b in zip(ref, got):
      if a is None:
        assert b is None
      else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('fanouts', [[15, 10, 5], [16], [17, 3], [65],
                                     [129], [300, 2]])
def test_choose_padded_window_matches_jax(fanouts):
  assert tops.choose_padded_window(fanouts) == \
      jops.choose_padded_window(fanouts)


@pytest.mark.parametrize('window', [1, 8, 64])
def test_padded_table_stats_match_jax(window):
  ip, _, _ = _graph(21, hub_deg=500)
  assert tops.padded_table_stats(ip, window) == \
      jops.padded_table_stats(ip, window)
  empty = np.zeros(5, np.int64)
  assert tops.padded_table_stats(empty, window) == \
      jops.padded_table_stats(empty, window)
