"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc; without them they skip. On a
machine with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
They cover the edge cases the main-path check in chip_smoke.py does not:
empty batches, 2- and 1-byte aligned rows, int64 ids, a hub of high
degree, k above a warp.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops
from graphlearn_tpu_torch.ops import sample_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA GPU (the kernels have no CPU mode)')
  return torch.device('cuda')


@pytest.mark.parametrize('dtype,width', [
    (torch.float32, 100), (torch.bfloat16, 100), (torch.float16, 3),
    (torch.int32, 128), (torch.bfloat16, 1)])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
def test_gather_rows_kernel_matches_plain(cuda, dtype, width, id_dtype):
  gen = torch.Generator().manual_seed(width)
  n = 1000
  table = (torch.randn((n, width), generator=gen) * 100).to(dtype).to(cuda)
  ids = torch.randint(-5, n + 5, (4099,), generator=gen).to(id_dtype)
  ids = ids.to(cuda)
  before = ops.launch_counts()['gather_rows']
  got = ops.gather_rows_hbm(table, ids)
  torch.cuda.synchronize()
  assert torch.equal(got, ops.gather_rows_plain(table, ids))
  assert ops.launch_counts()['gather_rows'] == before + 1
  empty = ops.gather_rows_hbm(table, ids[:0])
  assert empty.shape == (0, width)
  assert ops.launch_counts()['gather_rows'] == before + 1


@pytest.mark.parametrize('k', [5, 12, 40, 3])
def test_sample_hop_kernel_matches_plain(cuda, k):
  rng = np.random.default_rng(k)
  n, e = 300, 20000
  rows = rng.integers(0, n, e)
  rows[:900] = 3                      # a hub of degree above 900
  ei = np.stack([rows, rng.integers(0, n, e)])
  g = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device=cuda)
  seeds = torch.as_tensor(rng.integers(0, n, 777).astype(np.int32)).to(cuda)
  seeds[:4] = 3
  mask = torch.as_tensor(rng.random(777) < 0.9).to(cuda)
  key = gtt.random.fold_in(gtt.random.PRNGKey(5), k)
  row = g.csr_meta[torch.where(mask, seeds, 0).long()]
  start, deg = row[:, 0].contiguous(), row[:, 1].contiguous()
  epos, m = sample_fused._draw(start, deg, mask, k, key)
  safe = torch.where(m, epos, 0)
  empty = ops.sample_hop(g.indices, safe[:0])
  assert empty.shape == (0, k)
  got = ops.sample_hop(g.indices, safe)
  torch.cuda.synchronize()
  assert torch.equal(got, ops.sample_hop_plain(g.indices, safe))
  # the fused hop on the card equals the plain hop on the CPU
  ref = ops.uniform_sample(g.indptr.cpu(), g.indices.cpu(), seeds.cpu(),
                           mask.cpu(), k, key, meta=g.csr_meta.cpu())
  out = ops.sample_hop_fused(g.indptr, g.indices, None, seeds, mask, k, key,
                             meta=g.csr_meta)
  for a, b in zip(ref, out):
    assert torch.equal(a, b.cpu())
