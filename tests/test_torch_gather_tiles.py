"""The gather-v2 kernel's in-tile plan (``plan_runs_in_tiles``) and its
torch executor (``apply_gather_plan``), against the JAX package.

The CUDA kernel finds runs of consecutive ids in caller order inside each
``block_rows`` tile, with no sort; ``plan_runs_in_tiles`` is the same plan
in torch. Here it must be a partition of the slots (every slot written
exactly once; every run inside its tile and the table, its ids strictly
consecutive), its result must equal ``gather_rows_plain`` and the JAX
``jnp.take(table, clip(ids))`` on inputs made with numpy from a seed, and
on ascending ids it must equal the JAX package's own plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops import gather_pallas as jg
from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch.ops import gather

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N_ROWS = 3000
B = 2500          # not a multiple of 16, 256 or 1024: a ragged last tile
AT = 1030         # where a case puts its run: inside a 1024-slot tile


def _case_ids(case, span, rng):
  """Random ids (which seldom form runs) with the case's stretch written
  at slot AT."""
  ids = rng.integers(0, N_ROWS, B)
  stretch = {
      'run-span': np.arange(100, 100 + span),
      'run-span-minus-1': np.arange(100, 100 + span - 1),
      'run-3span-plus-1': np.arange(100, 100 + 3 * span + 1),
      'table-end': np.arange(N_ROWS - 2 * span, N_ROWS),
  }.get(case)
  if case == 'empty':
    return np.zeros(0, np.int64)
  if case == 'all-equal':
    return np.full(B, 17)
  if case == 'tile-cross':
    # a stretch over the 1024- and 256-slot tile boundary at slot 1024
    ids[1024 - 40:1024 + 40] = np.arange(500, 580)
  if case == 'out-of-range':
    # negative ids and ids >= N clamp to rows 0 and N-1; a stretch that
    # walks off the table's end clamps to N-1 and ends there
    ids[::7] = -rng.integers(1, 1000, ids[::7].size)
    ids[3::11] = N_ROWS + rng.integers(0, 1000, ids[3::11].size)
    ids[AT:AT + 20] = np.arange(N_ROWS - 10, N_ROWS + 10)
  if case == 'int64':
    ids = rng.integers(-5, N_ROWS + 5, B)
    ids[AT:AT + 30] = np.arange(40, 70)
  if stretch is not None:
    ids[AT:AT + stretch.size] = stretch
    if AT + stretch.size < B:
      ids[AT + stretch.size] = 0     # ends the stretch
    ids[AT - 1] = 0
  return ids


CASES = ['empty', 'ragged', 'all-equal', 'run-span', 'run-span-minus-1',
         'run-3span-plus-1', 'tile-cross', 'table-end', 'out-of-range',
         'int64']


def _check_partition(ids_np, plan, block_rows, span):
  """Every slot written exactly once; runs inside their tile and the
  table, strictly consecutive, starting where the clamped id says."""
  clamped = np.clip(ids_np, 0, N_ROWS - 1)
  kind, row = (t.numpy() for t in ops.decode_gather_plan(plan))
  assert set(np.unique(kind)) <= {0, 1, 2}
  np.testing.assert_array_equal(row, clamped)
  tile = min(block_rows, gather.GATHER_RUNS_MAX_TILE)
  writes = np.zeros(ids_np.size, np.int64)
  for j in np.flatnonzero(kind == 0):
    writes[j] += 1
  for j in np.flatnonzero(kind == 1):
    pos = j % block_rows % tile
    assert pos + span <= tile                        # stays in its tile
    assert j % block_rows + span <= block_rows       # and in its block
    assert j + span <= ids_np.size
    assert clamped[j] + span <= N_ROWS               # and in the table
    np.testing.assert_array_equal(clamped[j:j + span],
                                  clamped[j] + np.arange(span))
    writes[j:j + span] += 1
    assert (kind[j + 1:j + span] == 2).all()
  np.testing.assert_array_equal(writes, 1)
  return kind


@pytest.mark.parametrize('run_span', [1, 8])
@pytest.mark.parametrize('block_rows', [1, 16, 256, 1024])
@pytest.mark.parametrize('case', CASES)
def test_plan_runs_in_tiles_partition_and_result(case, block_rows, run_span):
  rng = np.random.default_rng(CASES.index(case))
  ids_np = _case_ids(case, run_span, rng)
  table_np = rng.standard_normal((N_ROWS, 7)).astype(np.float32)
  dtype = torch.int64 if case == 'int64' else torch.int32
  ids = torch.as_tensor(ids_np).to(dtype)
  table = torch.as_tensor(table_np)
  plan = ops.plan_runs_in_tiles(ids, N_ROWS, block_rows, run_span)
  assert plan.dtype == torch.int32 and plan.shape == ids.shape
  kind = _check_partition(ids_np, plan, block_rows, run_span)
  got = ops.apply_gather_plan(table, plan, run_span)
  assert torch.equal(got, ops.gather_rows_plain(table, ids))
  want = np.asarray(jnp.take(jnp.asarray(table_np),
                             jnp.clip(jnp.asarray(ids_np), 0, N_ROWS - 1),
                             axis=0))
  np.testing.assert_array_equal(got.numpy(), want)
  # where the case's stretch sits inside one tile, its runs are known
  if block_rows >= 256 and run_span == 8:
    runs_at = int((kind[AT:AT + 3 * run_span + 1] == 1).sum())
    expect = {'run-span': 1, 'run-span-minus-1': 0,
              'run-3span-plus-1': 3}.get(case)
    if expect is not None:
      assert runs_at == expect
      assert kind[AT + expect * run_span] == 0   # the remainder copies alone
  if case == 'all-equal' and run_span > 1:
    assert not (kind == 1).any()
  if run_span == 1 and ids_np.size:
    assert (kind == 1).all()          # every slot is a one-row run
  if case == 'tile-cross' and run_span == 8 and block_rows in (256, 1024):
    # the stretch [984, 1064) breaks at slot 1024: no run crosses it
    starts = np.flatnonzero(kind == 1)
    assert not ((starts < 1024) & (starts + run_span > 1024)).any()
    assert ((starts >= 984) & (starts < 1064)).sum() == 10
  if case == 'table-end' and block_rows >= 256:
    # the second run ends on the table's last row
    assert kind[AT + run_span] == 1
    assert ids_np[AT + 2 * run_span - 1] == N_ROWS - 1


@pytest.mark.parametrize('block_rows,run_span', [
    (16, 4), (256, 8), (8, 8), (7, 3), (1024, 8)])
def test_plan_runs_in_tiles_equals_the_jax_plan_on_ascending_ids(
    block_rows, run_span):
  """On ascending ids the caller order is the sorted order, so the
  kernel's plan is the JAX package's plan over the same slots."""
  rng = np.random.default_rng(block_rows)
  ids = np.sort(np.concatenate([rng.integers(0, N_ROWS, 900),
                                np.arange(1200, 1300),
                                np.arange(N_ROWS - 30, N_ROWS + 5)]))
  sid = np.clip(ids, 0, N_ROWS - 1).astype(np.int32)
  g = min(block_rows, sid.size)
  pad = (-sid.size) % g
  want = np.asarray(jg.plan_gather_runs(
      jnp.asarray(np.concatenate([sid, np.zeros(pad, np.int32)])), N_ROWS,
      g, min(run_span, g)))[:sid.size]
  got = ops.plan_runs_in_tiles(torch.as_tensor(ids), N_ROWS, block_rows,
                               run_span)
  np.testing.assert_array_equal(got.numpy(), want)
  assert (ops.decode_gather_plan(got)[0] == 1).any()


def test_plan_runs_in_tiles_cuts_long_blocks_into_tiles(monkeypatch):
  """A block longer than the kernel's tile is cut into tiles from the
  block's start: a stretch over a tile edge inside a block breaks there."""
  monkeypatch.setattr(gather, 'GATHER_RUNS_MAX_TILE', 64)
  ids = torch.arange(300, dtype=torch.int32)
  plan = ops.plan_runs_in_tiles(ids, N_ROWS, 100, 8)
  kind = ops.decode_gather_plan(plan)[0].numpy()
  # block 0: tiles [0, 64), [64, 100); block 1: [100, 164), [164, 200) ...
  starts = np.flatnonzero(kind == 1)
  for edge in (64, 100, 164, 200, 264):
    assert not ((starts < edge) & (starts + 8 > edge)).any()
  assert 64 in starts and 100 in starts and 164 in starts
  assert (kind[96:100] == 0).all()    # [64, 100) holds 4 runs, then 4 singles
  assert torch.equal(ops.apply_gather_plan(
      torch.arange(N_ROWS, dtype=torch.float32)[:, None], plan, 8)[:, 0],
                     ids.float())


def test_plan_runs_in_tiles_refuses_bad_arguments():
  ids = torch.zeros(3, dtype=torch.int32)
  with pytest.raises(ValueError, match='run_span'):
    ops.plan_runs_in_tiles(ids, 10, 16, 0)
  with pytest.raises(ValueError, match='block_rows'):
    ops.plan_runs_in_tiles(ids, 10, 0, 8)
  with pytest.raises(ValueError, match='30 bits'):
    ops.plan_runs_in_tiles(ids, 2 ** 30, 16, 8)
