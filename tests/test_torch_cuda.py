"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc; without them they skip. On a
machine with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
They cover the edge cases the main-path check in chip_smoke.py does not:
empty batches, 2- and 1-byte aligned rows, int64 ids, a hub of high
degree, k above a warp; and for the level kernel an empty frontier, all
slots masked, every pick already in the prefix, heavy duplicates,
truncation (num_new > limit), deg-0 and hub seeds, S far above the TPU
kernel's 32,768, and two calls giving the same bytes.
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


def _level_inputs(cuda, case, seed=0):
  """A graph with a hub (node 3) and a deg-0 node (n-1), a node-buffer
  prefix of 700 nodes (600 occupied), and one level's draw."""
  rng = np.random.default_rng(seed)
  n, e = 5000, 200_000
  rows = rng.integers(0, n - 1, e)
  rows[:5000] = 3
  cols = rng.integers(0, 400 if case == 'dups' else n, e)
  g = gtt.data.Graph(gtt.data.Topology(np.stack([rows, cols]),
                                       num_nodes=n), device=cuda)
  f, k = {'empty': (0, 5), 'wide': (4096, 15)}.get(case, (1500, 10))
  seeds = torch.as_tensor(rng.integers(0, n, f).astype(np.int32))
  seeds[:2] = torch.tensor([3, n - 1], dtype=torch.int32)[:f]
  mask = torch.as_tensor(rng.random(f) < (0.0 if case == 'masked'
                                          else 0.95))
  prefix = torch.as_tensor(rng.permutation(n)[:700].astype(np.int32))
  if case == 'found':
    # every id of the graph's adjacency is in the occupied prefix
    prefix = torch.as_tensor(np.concatenate([
        np.unique(cols).astype(np.int32),
        np.full(700, -1, np.int32)]))
  num_nodes = torch.tensor(min(600, prefix.shape[0]) if case != 'found'
                           else int((prefix >= 0).sum()), dtype=torch.int32)
  row = g.csr_meta[torch.where(mask, seeds, 0).long().to(cuda)]
  key = gtt.random.fold_in(gtt.random.PRNGKey(4), seed)
  epos, m = sample_fused._draw(row[:, 0], row[:, 1], mask.to(cuda), k, key)
  safe = torch.where(m, epos, 0)
  return g, safe, m, prefix.to(cuda), num_nodes.to(cuda), n


@pytest.mark.parametrize('case', ['empty', 'masked', 'found', 'dups',
                                  'wide', 'hubs'])
@pytest.mark.parametrize('limit', [50_000, 300])
def test_sample_level_kernel_matches_plain(cuda, case, limit):
  g, safe, m, prefix, nn, n = _level_inputs(cuda, case)
  before = ops.launch_counts()['sample_level']
  got = ops.sample_level(g.indices, safe, m, prefix, nn, limit, n)
  again = ops.sample_level(g.indices, safe, m, prefix, nn, limit, n)
  torch.cuda.synchronize()
  assert ops.launch_counts()['sample_level'] == before + 2
  ref = ops.sample_level_plain(g.indices, safe, m, prefix, nn, limit, n)
  for name, a, b, c in zip(('picked', 'cols_raw', 'block', 'num_new'),
                           got, again, ref):
    assert torch.equal(a, c), name
    assert torch.equal(a, b), name          # same bytes on every call
  if case == 'wide':
    assert safe.numel() > 32768
  if case == 'masked':
    assert int(got[3]) == 0 and bool((got[1] == -1).all())
  if case == 'found':
    assert int(got[3]) == 0
  if limit == 300 and case in ('dups', 'wide', 'hubs'):
    assert int(got[3]) > limit               # truncated


def test_sample_level_fused_on_card_matches_cpu_route(cuda):
  """Two merge levels on the card (kernel route) against the CPU route
  (JAX fallback): nodes, counts and every output equal; the sorted view is
  not compared (the kernel route leaves it stale, as on the TPU). The
  card route makes no host sync (torch's sync debug mode raises on one)."""
  rng = np.random.default_rng(9)
  n = 3000
  ei = np.stack([rng.integers(0, n, 60_000), rng.integers(0, 900, 60_000)])
  g = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device=cuda)
  seeds = torch.as_tensor(rng.integers(0, n, 256).astype(np.int32))
  smask = torch.arange(256) < 250
  caps = [256, 1024, 2048]
  outs = {}
  keys = [gtt.random.fold_in(gtt.random.PRNGKey(1), i) for i in range(2)]
  for dev in ('cpu', cuda):
    gg = g if dev == cuda else gtt.data.Graph(g.topo, device='cpu')
    s, m = seeds.to(dev), smask.to(dev)
    meta = gg.csr_meta          # built (and cached) before the checked part
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error' if dev == cuda else 'default')
    try:
      st, fr, fm, _ = ops.init_node_merge(s, m, sum(caps))
      fidx = torch.arange(256, dtype=torch.int32, device=dev)
      res = []
      for i, k in enumerate((10, 5)):
        st, out, _, _ = ops.sample_level_fused(
            gg.indptr, gg.indices, None, fr, fm, k, keys[i], st, fidx,
            meta=meta, prefix_cap=sum(caps[:i + 1]),
            max_new=caps[i + 1], final=(i == 1))
        res.append(out)
        fr, fidx, fm = (out[kk][:caps[i + 1]] for kk in
                        ('frontier', 'frontier_idx', 'frontier_mask'))
    finally:
      torch.cuda.set_sync_debug_mode('default')
    res = [{kk: v.cpu() for kk, v in out.items()} for out in res]
    res.append({'nodes': st.nodes.cpu(), 'num_nodes': st.num_nodes.cpu()})
    outs[str(dev)] = res
  for a, b in zip(outs['cpu'], outs[str(cuda)]):
    for name in a:
      assert torch.equal(a[name], b[name]), name
