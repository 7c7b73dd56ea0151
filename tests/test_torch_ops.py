"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a seed; the JAX functions that reach a
Pallas kernel run it through the interpreter (``interpret=True``), as
tests/test_ops.py does. Ids, masks, counts and features are compared
exactly. On CPU tensors the port's kernel wrappers take their plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
from graphlearn_tpu import ops as jops
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops as tops
from graphlearn_tpu_torch import random as trandom


def _t(a):
  return torch.as_tensor(np.asarray(a))


def _eq(a, b):
  np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _csr(rng, n, e, hub_deg=0):
  rows = rng.integers(0, n, e)
  if hub_deg:
    rows = np.concatenate([np.zeros(hub_deg, np.int64), rows])
  cols = rng.integers(0, n, rows.shape[0])
  order = np.lexsort((cols, rows))
  rows, cols = rows[order], cols[order]
  indptr = np.concatenate(
      [[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int32)
  return indptr, cols.astype(np.int32)


def _keys(trial):
  return (jax.random.fold_in(jax.random.PRNGKey(1), trial),
          trandom.fold_in(trandom.PRNGKey(1), trial))


def test_uniform_sample_matches_jax():
  rng = np.random.default_rng(4)
  n = 120
  ip, ind = _csr(rng, n, 2000, hub_deg=300)
  meta = np.stack([ip[:-1], ip[1:] - ip[:-1]], 1).astype(np.int32)
  for trial, k in ((0, 4), (1, 15)):
    jkey, tkey = _keys(trial)
    seeds = np.concatenate([[0, n - 1], rng.integers(0, n, 38)]).astype(
        np.int32)
    mask = rng.random(40) < 0.8
    for m in (meta, None):
      ref = jops.uniform_sample(jnp.asarray(ip), jnp.asarray(ind),
                                jnp.asarray(seeds), jnp.asarray(mask), k,
                                jkey, meta=None if m is None else
                                jnp.asarray(m))
      got = tops.uniform_sample(_t(ip), _t(ind), _t(seeds), _t(mask), k,
                                tkey, meta=None if m is None else _t(m))
      for a, b in zip(ref, got):
        _eq(a, b)


def test_sample_hop_fused_matches_interpret_kernel():
  """Mirrors tests/test_ops.py's fused-hop parity: a hub of degree 700
  above windows 128 and 256, masked seeds, k = 5 and 12, meta and
  indptr row lookup; the JAX side runs the Pallas hop kernel through
  the interpreter."""
  rng = np.random.default_rng(5)
  n = 150
  ip, ind = _csr(rng, n, 1200, hub_deg=700)
  meta = np.stack([ip[:-1], ip[1:] - ip[:-1]], 1).astype(np.int32)
  for window in (128, 256):
    blocks = jops.build_indices128(jnp.asarray(ind),
                                   min_rows=window // 128 + 1)
    for trial, k in ((0, 5), (1, 12)):
      jkey, tkey = _keys(trial)
      seeds = np.concatenate([[0], rng.integers(0, n, 23)]).astype(np.int32)
      mask = rng.random(24) < 0.85
      metas = (meta, None) if window == 128 and k == 5 else (meta,)
      for m in metas:
        ref = jops.sample_hop_fused(
            jnp.asarray(ip), jnp.asarray(ind), blocks, jnp.asarray(seeds),
            jnp.asarray(mask), k, jkey,
            meta=None if m is None else jnp.asarray(m), window=window,
            block_seeds=8, interpret=True)
        got = tops.sample_hop_fused(
            _t(ip), _t(ind), None, _t(seeds), _t(mask), k, tkey,
            meta=None if m is None else _t(m))
        for a, b in zip(ref, got):
          _eq(a, b)
  assert tops.launch_counts()['sample_hop'] == 0


def test_gather_rows_matches_interpret_kernel():
  """Mirrors tests/test_ops.py's row-gather parity: F = 100, duplicate
  ids, and clamping of out-of-range ids (200 and -5)."""
  rng = np.random.default_rng(0)
  table = rng.random((97, 100), np.float32)
  ids = np.array([0, 96, 7, 7, 45, 3, 8, 12, 1, 0, 33], np.int32)
  ref = jops.gather_rows_hbm(jnp.asarray(table), jnp.asarray(ids),
                             block_rows=4, interpret=True)
  _eq(ref, tops.gather_rows_hbm(_t(table), _t(ids)))
  oob = np.array([200, -5], np.int32)
  ref = jops.gather_rows_hbm(jnp.asarray(table), jnp.asarray(oob),
                             block_rows=2, interpret=True)
  got = tops.gather_rows_hbm(_t(table), _t(oob))
  _eq(ref, got)
  np.testing.assert_array_equal(got.numpy(), table[[96, 0]])
  assert tops.gather_rows_hbm(_t(table), _t(ids[:0])).shape == (0, 100)
  assert tops.launch_counts()['gather_rows'] == 0


@pytest.mark.parametrize('k', [3, 6])
def test_induce_next_tree_matches_jax(k):
  rng = np.random.default_rng(k)
  b, cap = 8, 8 + 8 * k
  seeds = rng.integers(0, 50, b).astype(np.int32)
  smask = np.arange(b) < 6
  nbrs = rng.integers(0, 50, (b, k)).astype(np.int32)
  nmask = rng.random((b, k)) < 0.7
  nbrs = np.where(nmask, nbrs, -1).astype(np.int32)
  jst, juniq, jm, jinv = jops.init_node_tree(jnp.asarray(seeds),
                                             jnp.asarray(smask), cap)
  tst, tuniq, tm, tinv = tops.init_node_tree(_t(seeds), _t(smask), cap)
  for a, bb in ((jst.nodes, tst.nodes), (jst.num_nodes, tst.num_nodes),
                (juniq, tuniq), (jinv, tinv)):
    _eq(a, bb)
  fidx = np.arange(b, dtype=np.int32)
  jst2, jout = jops.induce_next_tree(jst, jnp.asarray(fidx),
                                     jnp.asarray(nbrs), jnp.asarray(nmask),
                                     offset=b)
  tst2, tout = tops.induce_next_tree(tst, _t(fidx), _t(nbrs), _t(nmask),
                                     offset=b)
  _eq(jst2.nodes, tst2.nodes)
  _eq(jst2.num_nodes, tst2.num_nodes)
  for name in jout:
    _eq(jout[name], tout[name])


def test_feature_lookup_matches_jax():
  """Feature[ids]: FILL slots read storage row 0 after the id2index
  remap, in both packages."""
  rng = np.random.default_rng(8)
  feats = rng.standard_normal((40, 6)).astype(np.float32)
  ids = np.array([3, -1, 39, 0, 3, -1, 17], np.int32)
  for id2index in (None, rng.permutation(40).astype(np.int32)):
    ref = glt.data.Feature(feats, split_ratio=1.0, id2index=id2index)[ids]
    got = gtt.data.Feature(feats, device='cpu', id2index=id2index)[ids]
    _eq(ref, got)


def test_collate_batch_matches_jax():
  rng = np.random.default_rng(2)
  n, f, cap_n, cap_e = 60, 100, 40, 32
  feats = rng.standard_normal((n, f)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  node = np.full(cap_n, -1, np.int32)
  node[:29] = rng.integers(0, n, 29)
  row = rng.integers(-1, cap_n, cap_e).astype(np.int32)
  col = rng.integers(-1, cap_n, cap_e).astype(np.int32)
  for label_cap in (None, 8):
    ref = jops.collate_batch(jnp.asarray(node), jnp.asarray(29),
                             jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(feats), None, jnp.asarray(labels),
                             None, None, label_cap=label_cap)
    got = tops.collate_batch(_t(node), torch.tensor(29), _t(row), _t(col),
                             _t(feats), None, _t(labels), None, None,
                             label_cap=label_cap)
    for key in ('node_mask', 'edge_index', 'x', 'y'):
      _eq(ref[key], got[key])
    assert got['edge_attr'] is None
