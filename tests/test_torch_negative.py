"""The port's negative sampling against the JAX package, on the CPU.

- ``random.randint`` equals ``jax.random.randint`` bit for bit at spans
  on both sides of 65,536, where JAX's uint32 range reduction starts to
  wrap (its multiplier ``(2**16 % span)**2`` is 0 mod 2**32 from span
  65,537 on): int64 arithmetic without the wrap agrees with JAX on no
  larger span. A numpy emulation of the kernel's integer steps
  (``csrc/negative_sample.cu``: the subkeys, the words, the uint32
  reduction, the binary search stopped at lo >= hi) equals both.
- ``edge_in_csr`` and ``sort_csr_segments`` against JAX's.
- ``random_negative_sample`` strict and padded, on a sparse and a dense
  graph (a shortfall: some of the ``num_samples`` slots stay positive),
  at a span below and one above 65,536.
- ``RandomNegativeSampler`` over three calls, ``edge_dir='out'`` and
  ``'in'``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import random as trandom
from test_torch_draw import threefry

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

U32 = np.uint32
SPANS = (60_000, 65_536, 65_537, 1_000_003)


def _jkey(seed):
  return jax.random.PRNGKey(seed)


@pytest.mark.parametrize('span', SPANS + (1, 7, 2 ** 31 - 1))
@pytest.mark.parametrize('seed', [7, 11])
def test_randint_matches_jax(span, seed):
  want = np.asarray(jax.random.randint(_jkey(seed), (4096,), 0, span,
                                       dtype=jnp.int32))
  got = trandom.randint(trandom.PRNGKey(seed), (4096,), 0, span)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('lo,hi', [(-5, 10), (10, 3), (4, 4),
                                   (-2 ** 31, 2 ** 31 - 1)])
def test_randint_ranges_match_jax(lo, hi):
  want = np.asarray(jax.random.randint(_jkey(3), (999,), lo, hi,
                                       dtype=jnp.int32))
  got = trandom.randint(trandom.PRNGKey(3), (999,), lo, hi)
  np.testing.assert_array_equal(got.numpy(), want)


def test_randint_is_not_int64_arithmetic_past_65536():
  """The hazard the uint32 emulation holds: without the wrap the values
  part from JAX's at every span from 65,537 on."""
  span = 1_000_003
  key = trandom.PRNGKey(7)
  k_hi, k_lo = trandom.split(key)
  hi = trandom.random_bits(k_hi, (4096,))
  lo = trandom.random_bits(k_lo, (4096,))
  mult = (2 ** 16 % span) ** 2 % span           # unwrapped: not 0
  naive = ((hi % span) * mult + lo % span) % span
  want = np.asarray(jax.random.randint(_jkey(7), (4096,), 0, span,
                                       dtype=jnp.int32))
  assert (naive.numpy() != want).mean() > 0.9
  np.testing.assert_array_equal(
      trandom.randint(key, (4096,), 0, span).numpy(), want)


# ------------------------------------------- the kernel's steps in numpy


def _split(k, j):
  y0, y1 = threefry(k[0], k[1], 0, j)
  return int(y0), int(y1)


def _words(k, n):
  i = np.arange(n, dtype=np.uint64)
  y0, y1 = threefry(k[0], k[1], (i >> np.uint64(32)).astype(U32),
                    (i & np.uint64(0xFFFFFFFF)).astype(U32))
  return y0 ^ y1


def _reduce(higher, lower, span):
  span = U32(span)
  with np.errstate(over='ignore'):
    mult = (U32(65536) % span) * (U32(65536) % span) % span
    return ((higher % span) * mult + lower % span) % span


def kernel_emulation(key, indptr, sorted_indices, num_src, num_dst, total):
  """``negative_sample_kernel``, thread by thread: ``(rows, cols,
  valid)``."""
  k = tuple(int(w) & 0xFFFFFFFF for w in key)
  kr, kc = _split(k, 0), _split(k, 1)
  rows = _reduce(_words(_split(kr, 0), total), _words(_split(kr, 1), total),
                 max(num_src, 1)).astype(np.int64)
  cols = _reduce(_words(_split(kc, 0), total), _words(_split(kc, 1), total),
                 max(num_dst, 1)).astype(np.int64)
  n_ptr, n_e = len(indptr), len(sorted_indices)
  valid = np.ones(total, bool)
  for i, (r, c) in enumerate(zip(rows, cols)):
    end = int(indptr[min(r + 1, n_ptr - 1)])
    lo, hi = int(indptr[min(r, n_ptr - 1)]), end
    if n_e == 0:
      continue
    for _ in range(32):
      if lo >= hi:
        break
      mid = (lo + hi) // 2
      if sorted_indices[min(max(mid, 0), n_e - 1)] < c:
        lo = mid + 1
      else:
        hi = mid
    valid[i] = not (lo < end and
                    sorted_indices[min(max(lo, 0), n_e - 1)] == c)
  return rows.astype(np.int32), cols.astype(np.int32), valid


def _graph(n, e, seed=0, dense_rows=0):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, e)
  cols = rng.integers(0, n, e)
  if dense_rows:     # rows 0..dense_rows-1 point at every node: no negative
    full = np.arange(n)
    rows = np.concatenate([rows] + [np.full(n, r) for r in range(dense_rows)])
    cols = np.concatenate([cols] + [full] * dense_rows)
  return np.stack([rows, cols])


def _csr(ei, n):
  jt = glt.data.Topology(ei, num_nodes=n)
  tt = gtt.data.Topology(ei, num_nodes=n)
  js, _ = glt.ops.sort_csr_segments(jt.indptr, jt.indices)
  ts, perm = gtt.ops.sort_csr_segments(tt.indptr, tt.indices)
  np.testing.assert_array_equal(ts, js)
  np.testing.assert_array_equal(perm, glt.ops.sort_csr_segments(
      jt.indptr, jt.indices)[1])
  # the device form (the samplers' view) gives the same values
  np.testing.assert_array_equal(gtt.ops.sort_csr_rows(
      torch.as_tensor(tt.indptr.astype(np.int32)),
      torch.as_tensor(tt.indices)).numpy(), js)
  indptr = jt.indptr.astype(np.int32)
  return (jnp.asarray(indptr), jnp.asarray(js), torch.as_tensor(indptr),
          torch.as_tensor(ts.astype(np.int32)))


@pytest.mark.parametrize('n,e', [(40, 300), (70_001, 200_000)])
def test_kernel_emulation_matches_plain_and_jax(n, e):
  ei = _graph(n, e)
  _, _, tptr, tidx = _csr(ei, n)
  key = trandom.fold_in(trandom.PRNGKey(5), 9)
  total = 3000
  rows, cols, valid = gtt.ops.negative.negative_candidates_plain(
      tptr, tidx, n, n, total, key)
  er, ec, ev = kernel_emulation(key.tolist(), tptr.numpy(), tidx.numpy(), n,
                                n, total)
  np.testing.assert_array_equal(rows.numpy(), er)
  np.testing.assert_array_equal(cols.numpy(), ec)
  np.testing.assert_array_equal(valid.numpy(), ev)
  # JAX's own draws for the same split
  kr, kc = jax.random.split(jnp.asarray(key.numpy().astype(np.uint32)))
  np.testing.assert_array_equal(
      er, np.asarray(jax.random.randint(kr, (total,), 0, n, jnp.int32)))
  np.testing.assert_array_equal(
      ec, np.asarray(jax.random.randint(kc, (total,), 0, n, jnp.int32)))


def test_edge_in_csr_matches_jax():
  n = 30
  ei = _graph(n, 200, seed=3)
  jptr, jidx, tptr, tidx = _csr(ei, n)
  rng = np.random.default_rng(1)
  # every edge, and random pairs (most of them absent)
  qr = np.concatenate([ei[0], rng.integers(0, n, 500)]).astype(np.int32)
  qc = np.concatenate([ei[1], rng.integers(0, n, 500)]).astype(np.int32)
  want = np.asarray(glt.ops.edge_in_csr(jptr, jidx, jnp.asarray(qr),
                                        jnp.asarray(qc)))
  got = gtt.ops.edge_in_csr(tptr, tidx, torch.as_tensor(qr),
                            torch.as_tensor(qc))
  np.testing.assert_array_equal(got.numpy(), want)
  assert want[:ei.shape[1]].all() and not want.all()
  edges = set(zip(ei[0].tolist(), ei[1].tolist()))
  assert [(r, c) in edges for r, c in zip(qr, qc)] == want.tolist()


@pytest.mark.parametrize('padding', [False, True])
@pytest.mark.parametrize('case', ['sparse', 'dense', 'wide'])
def test_random_negative_sample_matches_jax(case, padding):
  n, e, dense, num, trials = dict(
      sparse=(50, 200, 0, 64, 5), dense=(12, 10, 9, 40, 2),
      wide=(70_001, 100_000, 0, 512, 5))[case]
  ei = _graph(n, e, dense_rows=dense)
  jptr, jidx, tptr, tidx = _csr(ei, n)
  for seed in (0, 1):
    want = glt.ops.random_negative_sample(jptr, jidx, n, n, num,
                                          _jkey(seed), trials=trials,
                                          padding=padding)
    got = gtt.ops.random_negative_sample(tptr, tidx, n, n, num,
                                         trandom.PRNGKey(seed),
                                         trials=trials, padding=padding)
    for w, g in zip(want, got):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = gtt.ops.random_negative_sample_plain(
        tptr, tidx, n, n, num, trandom.PRNGKey(seed), trials=trials,
        padding=padding)
    for p, g in zip(plain, got):
      assert torch.equal(p, g)
    rows, cols, mask = (t.numpy() for t in got)
    edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    strict_ok = [(r, c) not in edges for r, c in zip(rows, cols)]
    if padding:
      assert mask.all()
    else:
      np.testing.assert_array_equal(mask, strict_ok)
    if case == 'dense':
      # a shortfall: some slots hold positive (rejected) candidates
      assert not all(strict_ok)


@pytest.mark.parametrize('edge_dir', ['out', 'in'])
def test_random_negative_sampler_matches_jax(edge_dir):
  n = 40
  ei = _graph(n, 300, seed=2)
  layout = 'CSR' if edge_dir == 'out' else 'CSC'
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n, layout=layout),
                      'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n, layout=layout),
                      device='cpu')
  js = glt.sampler.RandomNegativeSampler(jg, edge_dir=edge_dir, seed=4)
  ts = gtt.sampler.RandomNegativeSampler(tg, edge_dir=edge_dir, seed=4)
  edges = set(zip(ei[0].tolist(), ei[1].tolist()))
  for call in range(3):
    want = js.sample(16, trials=3, padding=call == 2)
    got = ts.sample(16, trials=3, padding=call == 2)
    for w, g in zip(want, got):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows, cols, mask = (t.numpy() for t in got)
    # (src, dst) pairs of the COO graph whichever way it is stored
    for r, c, m in zip(rows, cols, mask):
      if m and call < 2:
        assert (int(r), int(c)) not in edges
  assert ts._call_count == js._call_count == 3
