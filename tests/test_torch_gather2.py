"""Gather v2 of the port against the JAX package.

``plan_gather_runs`` is bit-exact against the JAX plan on the id
distributions of benchmarks/prof_gather2.py (random, sorted-unique,
duplicate-heavy, one contiguous span) and the sorted-adversarial set of
tests/test_ops.py, at prime lengths; the plan is a partition of the
slots on the port's decode; ``gather_rows_hbm2`` (its CPU route, the
plain version) equals the JAX interpret-mode kernel and
``table[clip(ids)]`` exactly; and the routed all-device feature lookup
equals the unrouted one. Each interpret-mode shape compiles for a few
seconds, so those cases are few and small (block_rows <= 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.ops import gather_pallas as jg
from graphlearn_tpu_torch import ops

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N_ROWS = 5000


def _dists(rng, n, b):
  """benchmarks/prof_gather2.py's distributions, plus tests/test_ops.py's
  sorted-adversarial set (gaps, stutters, an exact span)."""
  c0 = rng.integers(0, n - b)
  return {
      'random': rng.integers(0, n, b),
      'sorted': np.sort(rng.choice(n, b, replace=False)),
      'dup': rng.choice(rng.integers(0, n, max(1, b // 16)), b),
      'runs': np.arange(c0, c0 + b),
      'sorted-adversarial': np.concatenate(
          [np.arange(40, 52), [52, 52, 52], np.arange(200, 204),
           rng.integers(0, n, b - 22)]),
  }


def _padded_sorted(ids, block_rows, run_span):
  sid = np.sort(np.clip(ids, 0, N_ROWS - 1)).astype(np.int32)
  g = min(block_rows, sid.size)
  pad = (-sid.size) % g
  return (np.concatenate([sid, np.zeros(pad, np.int32)]), g,
          min(run_span, g))


@pytest.mark.parametrize('dist', ['random', 'sorted', 'dup', 'runs',
                                  'sorted-adversarial'])
@pytest.mark.parametrize('b', [131, 1021])
def test_plan_gather_runs_bit_exact_against_jax(dist, b):
  rng = np.random.default_rng(b)
  ids = _dists(rng, N_ROWS, b)[dist]
  for block_rows, run_span in ((16, 4), (256, 8), (8, 8), (7, 3), (4, 1)):
    sid, g, span = _padded_sorted(ids, block_rows, run_span)
    want = np.asarray(jg.plan_gather_runs(jnp.asarray(sid), N_ROWS, g, span))
    got = ops.plan_gather_runs(torch.as_tensor(sid), N_ROWS, g, span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_gather_runs_covers_every_slot_exactly_once():
  """The plan is a partition: every slot is written by exactly one copy —
  its own single, or the full run that starts at most run_span-1 slots
  before it; full runs stay in their block and in the table and carry
  strictly consecutive ids. Covered slots decode as kind 2 (the int32
  sign bit), never -2."""
  rng = np.random.default_rng(3)
  n, block_rows, span = 500, 16, 4
  for trial in range(6):
    ids = np.sort(rng.integers(0, n, 64)).astype(np.int32)
    if trial == 4:     # fully contiguous best case
      ids = np.arange(100, 164, dtype=np.int32)
    if trial == 5:     # contiguous up to the table's last row
      ids = np.arange(n - 64, n, dtype=np.int32)
    plan = ops.plan_gather_runs(torch.as_tensor(ids), n, block_rows, span)
    kind, row = (t.numpy() for t in ops.decode_gather_plan(plan))
    assert set(np.unique(kind)) <= {0, 1, 2}
    np.testing.assert_array_equal(row, ids)
    writes = np.zeros(ids.shape[0], np.int64)
    for j, kd in enumerate(kind):
      if kd == 0:
        writes[j] += 1
      elif kd == 1:
        assert j % block_rows + span <= block_rows   # stays in block
        assert ids[j] + span <= n                    # stays in table
        np.testing.assert_array_equal(ids[j:j + span],
                                      ids[j] + np.arange(span))
        writes[j:j + span] += 1
    np.testing.assert_array_equal(writes, 1)
    if trial >= 4:
      assert (kind == 1).any() and (kind == 2).any()
      assert bool((plan < 0).any())            # kind 2 rides the sign bit


def _jax_table(table):
  if table.dtype == torch.bfloat16:
    return jnp.asarray(table.float().numpy(), dtype=jnp.bfloat16)
  return jnp.asarray(table.numpy())


@pytest.mark.parametrize('dtype,width,presorted', [
    (torch.float32, 128, False), (torch.float32, 128, True),
    (torch.bfloat16, 128, False), (torch.int32, 128, False),
    (torch.float32, 47, False)])
def test_gather_rows_hbm2_matches_jax_interpret(dtype, width, presorted):
  """Random ids with a contiguous stretch and the out-of-range ids
  [900, -3] (table of 300 rows), at a prime length; the non-128 width 47
  is the served GraphSAGE table's row shape."""
  rng = np.random.default_rng(width)
  n = 300
  table = torch.as_tensor(rng.standard_normal((n, width)) * 100).to(dtype)
  ids = np.concatenate([rng.integers(0, n, 20), np.arange(57, 70),
                        [900, -3, 299, 0]]).astype(np.int32)   # 37 ids
  if presorted:
    ids = np.sort(ids)
  want = np.asarray(jg.gather_rows_hbm2(
      _jax_table(table), jnp.asarray(ids), block_rows=16, run_span=4,
      presorted=presorted, interpret=True).astype(
          jnp.float32 if dtype == torch.bfloat16 else _jax_table(table).dtype))
  got = ops.gather_rows_hbm2(table, torch.as_tensor(ids), block_rows=16,
                             run_span=4, presorted=presorted)
  ref = table[torch.as_tensor(np.clip(ids, 0, n - 1)).long()]
  assert got.dtype == dtype and got.shape == (ids.size, width)
  assert torch.equal(got, ref)
  np.testing.assert_array_equal(
      (got.float() if dtype == torch.bfloat16 else got).numpy(), want)


def test_gather_rows_hbm2_empty_ids_match_jax():
  table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
  want = np.asarray(jg.gather_rows_hbm2(jnp.asarray(table.numpy()),
                                        jnp.zeros((0,), jnp.int32)))
  got = ops.gather_rows_hbm2(table, torch.zeros(0, dtype=torch.int32))
  assert got.shape == want.shape == (0, 4)


@pytest.mark.parametrize('case', [
    'b-above-block', 'run-at-table-end', 'all-equal', 'int64', 'span-1',
    'presorted-dups', 'block-1'])
def test_gather_rows_hbm2_plain_edge_cases(case):
  """The CPU route against table[clip(ids)] where the plan has its
  corners: B just above a multiple of the block with ids from 0 (the
  row-0 pad must not extend a run into real slots), runs ending at the
  table's last row, every id equal, int64 ids, run_span 1, duplicates
  presorted, block_rows 1."""
  rng = np.random.default_rng(7)
  n = 200
  table = torch.as_tensor(rng.standard_normal((n, 5)).astype(np.float32))
  kw = dict(block_rows=16, run_span=4)
  ids = {'b-above-block': np.arange(0, 33),
         'run-at-table-end': np.arange(n - 37, n + 3),
         'all-equal': np.full(50, 17),
         'int64': rng.integers(-10, n + 10, 77),
         'span-1': rng.integers(0, n, 40),
         'presorted-dups': np.sort(np.repeat(np.arange(30, 45), 3)),
         'block-1': np.arange(5, 45)}[case]
  if case == 'span-1':
    kw['run_span'] = 1
  if case == 'block-1':
    kw['block_rows'] = 1
  ids = torch.as_tensor(ids, dtype=torch.int64 if case == 'int64'
                        else torch.int32)
  got = ops.gather_rows_hbm2(table, ids, presorted=case == 'presorted-dups',
                             **kw)
  assert torch.equal(got, table[ids.clamp(0, n - 1).long()])
  if case in ('b-above-block', 'run-at-table-end'):
    sid, g, span = _padded_sorted(np.clip(ids.numpy(), 0, n - 1), 16, 4)
    kind, _ = ops.decode_gather_plan(
        ops.plan_gather_runs(torch.as_tensor(sid), n, g, span))
    assert bool((kind == 1).any())


def test_gather_rows_hbm2_refuses_bad_arguments():
  table = torch.zeros((4, 2))
  with pytest.raises(ValueError, match='CUDA'):
    ops.gather_rows_hbm2(table, torch.zeros(3, dtype=torch.int32,
                                            device='meta'))
  with pytest.raises(ValueError, match='run_span'):
    ops.gather_rows_hbm2(table, torch.zeros(3, dtype=torch.int32),
                         run_span=0)


def test_routed_feature_lookup_matches_unrouted():
  """Feature.set_kernel_routing(use_pallas_v2=True): the routed
  all-device lookup equals the unrouted one and the JAX Feature on the
  same ids (id2index resolved, FILL slots read row 0), and a
  NeighborLoader batch equals the batch with routing off. On CPU
  tensors nothing launches."""
  rng = np.random.default_rng(2)
  n, f = 120, 9
  ei = rng.integers(0, n, (2, 900))
  feats = rng.standard_normal((n, f)).astype(np.float32)
  id2index = rng.permutation(n)
  ids = np.concatenate([rng.integers(0, n, 60), np.arange(30, 50), [-1]])
  jfeat = glt.data.Feature(feats[np.argsort(id2index)], id2index=id2index)
  want = np.asarray(jfeat[jnp.asarray(ids)])
  batches = {}
  ops.reset_launch_counts()
  for routed in (False, True):
    ds = gtt.data.Dataset(device='cpu')
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feats[np.argsort(id2index)], id2idx=id2index)
    if routed:
      ds.node_features.set_kernel_routing(use_pallas_v2=True,
                                          block_rows=16, run_span=4)
    assert ds.node_features.unified.use_pallas_v2 == routed
    got = ds.node_features[torch.as_tensor(ids)]
    np.testing.assert_array_equal(got.numpy(), want)
    loader = gtt.loader.NeighborLoader(ds, [3, 2], np.arange(40),
                                       batch_size=16, device='cpu')
    batches[routed] = list(loader)
  for a, b in zip(batches[False], batches[True]):
    assert torch.equal(a.x, b.x) and torch.equal(a.node, b.node)
    assert torch.equal(a.edge_index, b.edge_index)
  assert sum(ops.launch_counts().values()) == 0
