"""The probe kernels' plain versions against the TPU probes' Pallas calls.

``benchmarks/prof_mem.py``'s ``pallas_row_gather`` (one grid step per
output row, the row picked by a scalar-prefetched id) and
``benchmarks/prof_dedup.py``'s ``pk`` (``jnp.take`` from a table held in
VMEM) are built here as those files build them and run in interpret
mode on the CPU; the port's ``row_gather_probe`` and ``smem_take`` (their
plain versions on CPU tensors) must equal them exactly. Where the grid
is empty, the reference is the ``jnp`` expression the kernel body
evaluates. An id out of range is clamped by the row gather (the
interpret-mode block index clamps the same way; the TPU leaves it
undefined) and fills ``INT32_MIN`` in the take, exactly as ``jnp.take``'s
default mode does, which also counts an id in ``[-TN, 0)`` from the end.
The probe suites themselves are rehearsed on the CPU at a small size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch.benchmarks import prof_dedup, prof_mem

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _pallas_row_gather(tbl, ridx):
  """``benchmarks/prof_mem.py:84-102``, in interpret mode."""

  def gather_kernel(idx_ref, tbl_ref, out_ref):
    out_ref[:] = tbl_ref[:]

  grid_spec = pltpu.PrefetchScalarGridSpec(
      num_scalar_prefetch=1,
      grid=(ridx.shape[0],),
      in_specs=[pl.BlockSpec((1, tbl.shape[1]),
                             lambda i, idx_ref: (idx_ref[i], 0))],
      out_specs=pl.BlockSpec((1, tbl.shape[1]), lambda i, idx_ref: (i, 0)),
  )
  return pl.pallas_call(
      gather_kernel,
      out_shape=jax.ShapeDtypeStruct((ridx.shape[0], tbl.shape[1]),
                                     tbl.dtype),
      grid_spec=grid_spec, interpret=True)(ridx, tbl)


def _pallas_vmem_take(t, i):
  """``benchmarks/prof_dedup.py:99-116`` (without the final sum), in
  interpret mode."""

  def pk(table_ref, idx_ref, out_ref):
    tab = table_ref[:]
    idx = idx_ref[:]
    out_ref[:] = jnp.take(tab.reshape(-1), idx.reshape(-1),
                          axis=0).reshape(idx.shape)

  return pl.pallas_call(
      pk, out_shape=jax.ShapeDtypeStruct(i.shape, jnp.int32),
      in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM)],
      out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
      interpret=True)(t, i)


@pytest.mark.parametrize('case', ['in_range', 'out_of_range'])
@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_row_gather_probe_plain_matches_pallas_interpret(case, dtype):
  rng = np.random.default_rng(3)
  n, width, b = 61, 128, 37
  tbl = (rng.standard_normal((n, width)) * 100).astype(dtype)
  ids = rng.integers(0, n, b).astype(np.int32)
  ids[0], ids[-1] = 0, n - 1
  if case == 'out_of_range':
    ids[3::5] = n + rng.integers(0, 1000, ids[3::5].shape)
    ids[4::7] = -rng.integers(1, 1000, ids[4::7].shape)
  ref = np.asarray(_pallas_row_gather(jnp.asarray(tbl), jnp.asarray(ids)))
  got = ops.row_gather_probe(torch.as_tensor(tbl), torch.as_tensor(ids))
  np.testing.assert_array_equal(got.numpy(), ref)
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(jnp.take(tbl, jnp.clip(ids, 0, n - 1), axis=0)))


def test_row_gather_probe_empty_ids():
  tbl = np.arange(12, dtype=np.float32).reshape(3, 4)
  ids = np.zeros(0, np.int32)
  got = ops.row_gather_probe(torch.as_tensor(tbl), torch.as_tensor(ids))
  ref = np.asarray(jnp.take(tbl, jnp.clip(ids, 0, 2), axis=0))
  assert got.shape == ref.shape == (0, 4)


@pytest.mark.parametrize('case', ['in_range', 'out_of_range'])
def test_smem_take_plain_matches_pallas_interpret(case):
  rng = np.random.default_rng(5)
  tn = 1 << 16
  table = rng.integers(0, 1 << 30, tn, dtype=np.int32)
  idx = rng.integers(0, tn, (48, 128), dtype=np.int32)
  idx[0, 0], idx[-1, -1] = 0, tn - 1
  if case == 'out_of_range':
    flat = idx.reshape(-1)
    flat[::97] = tn                        # one past the end: fill
    flat[1::89] = -tn - 1                  # below -TN: fill
    flat[2::83] = -1                       # counts from the end
    flat[3::79] = -tn
    flat[4::73] = np.iinfo(np.int32).max
    flat[5::71] = np.iinfo(np.int32).min
  ref = np.asarray(_pallas_vmem_take(jnp.asarray(table), jnp.asarray(idx)))
  got = ops.smem_take(torch.as_tensor(table), torch.as_tensor(idx))
  assert got.dtype == torch.int32 and got.shape == idx.shape
  np.testing.assert_array_equal(got.numpy(), ref)
  if case == 'out_of_range':
    assert (ref == ops.probes.FILL).any() and (ref != ops.probes.FILL).any()


def test_smem_take_empty_and_small_tables():
  rng = np.random.default_rng(6)
  for tn, shape in ((40, (0,)), (1, (9,)), (7, (3, 5))):
    table = rng.integers(0, 1 << 30, tn, dtype=np.int32)
    idx = rng.integers(-2 * tn, 2 * tn, shape).astype(np.int32)
    got = ops.smem_take(torch.as_tensor(table), torch.as_tensor(idx))
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('suite', [prof_mem, prof_dedup])
def test_probe_suites_rehearse_on_the_cpu(suite):
  ops.reset_launch_counts()
  recs = suite.run(torch.device('cpu'), iters=1, shrink=256)
  assert all(r['ms'] > 0 for r in recs)
  kernel = [r for r in recs if 'max_abs_err' in r]
  assert len(kernel) == 1 and kernel[0]['max_abs_err'] == 0
  # CPU tensors take the plain versions: no launch
  assert ops.launch_counts()['row_gather_probe_bulk'] == 0
  assert ops.launch_counts()['row_gather_probe_vector'] == 0
  assert ops.launch_counts()['smem_take'] == 0


@pytest.mark.parametrize('dtype,width,view,route', [
    (torch.float32, 128, 'whole', 'bulk'),     # the probe's 512-byte rows
    (torch.float32, 100, 'whole', 'bulk'),     # 400 B
    (torch.bfloat16, 47, 'whole', 'vector'),   # 94 B: not a multiple of 16
    (torch.int32, 600, 'whole', 'bulk'),       # 2400 B
    (torch.float32, 8, 'whole', 'bulk'),       # 32 B
    (torch.float32, 128, 'offset', 'vector')])  # base 4 bytes past 16
def test_row_gather_route_by_shape(dtype, width, view, route):
  """The route the row gather takes on the card, chosen by shape alone:
  bulk copies need a row of a multiple of 16 bytes on 16-byte aligned
  base pointers."""
  flat = torch.zeros(64 * width + 4, dtype=dtype)
  step = 4 // flat.element_size()
  start = (-flat.data_ptr() // flat.element_size()) % (16 // flat.element_size())
  table = flat[start + (step if view == 'offset' else 0):][:32 * width]
  table = table.view(32, width)
  assert (table.data_ptr() % 16 == 0) == (view == 'whole')
  assert ops.row_gather_route(table) == route
  out = torch.empty((5, width), dtype=dtype)
  assert ops.row_gather_route(table, out) == route
  # the CPU takes the plain version whatever the route
  ids = torch.tensor([0, 31, 40, -2, 7], dtype=torch.int32)
  assert torch.equal(ops.row_gather_probe(table, ids),
                     ops.row_gather_probe_plain(table, ids))
