"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc; without them they skip. On a
machine with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
They cover the edge cases the main-path check in chip_smoke.py does not:
empty batches, 2- and 1-byte aligned rows, int64 ids; for K1, both
entries, rows of 1 to 1,024 elements, id counts around a 32-id batch and
one above the persistent grid's rows a pass, a table view one element
off, a table and an output past 4 GiB, and a launch captured in a CUDA
graph and replayed over ids changed in place; for the fused hop
a hub of high degree, a deg-0 seed, k above a warp, the row table or
indptr, a host key against the same key on the device,
and two calls giving the same bytes; for the fused level an empty
frontier, all slots masked, every pick already in the buffer, heavy
duplicates, truncation (num_new > max_new), deg-0 and hub seeds, S far
above the TPU kernel's 32,768, two calls giving the same bytes, launches
per level and per batch, a scratch carried across levels under torch's
sync debug mode, and the sampler's batches on both engines against the
CPU's, made with no host sync; for the gather-v2
kernel empty ids, B not a multiple of block_rows, runs of exactly
run_span, run_span - 1 and 3 * run_span + 1 rows, a run over a tile edge
and one ending at the table's end, all-equal ids, f32/bf16/int32 at widths
47/100/128, a table view whose rows are not 16-byte aligned, int64 ids and
presorted ids, the kernel's own plan against plan_runs_in_tiles, one
device kernel per call (torch.profiler), a routed EmbeddingStore lookup,
and a small materialization on the card against the CPU; for the probe
kernels the probes' shapes, empty ids, int64 ids, odd widths and both
routes (row gather), and for the take, at cluster sizes 2, 4 and 8, a launch at a
non-multiple of its tile, odd, tiny and largest tables, TN below the
cluster size, id counts that are not multiples of 4, an id view that is
not 16-byte aligned, the fill and the negative ids that wrap, and a table
too large for the cluster; three train steps on the card against the
CPU, tree and merge; the chunk's hop keys against their plain version;
the captured ScanTrainer against the eager one, also when it is given
another Adam state between epochs; a captured crash and resume; a
checkpointed captured epoch with no host sync; the captured RunTrainer
against the eager one and ScanTrainer epochs, its early stop, and its
resume inside an epoch; OverlappedTrainer against the per-step
loop; the uniform draw kernel against ``random.uniform`` (device, host
and split keys); the block, padded, weighted and node_budget batches on
both engines against the CPU's, with the draw, hop and level launches
they make; the captured ScanTrainer on a reseeded padded table; a
padded-window crash and resume; bf16 train steps on both engines
against the CPU; the negative sampling kernel against its plain version
across span 65,536 (dense, empty and no-sample cases, host and device
keys, spans past the CSR's rows); link batches on the four engines
against the CPU's with their launches, a link batch with no host sync,
two link train steps against the CPU; subgraph batches, exact and
bucketed, against the CPU's; and the hot/cold gather against its plain
version bit for bit (H = 0, a mixed split, H = N; row widths down to 2
bytes; f32, bf16, f16, int32; int32 and int64 ids; random ids, one cold
row in every slot, every cold row 50 times, no duplicate), its fetch
counter equal to the distinct cold rows and no host sync, unmapped rows
refused, a mapped tail freed after its last launch and mapped again, a
hot/cold ``Feature`` on the card against the CPU's with no host sync in
the lookup, the in-process IPC round trip, the spawned two-worker
``feature_mp`` run and hot/cold loader batches against the CPU's; and
the tiered store: a captured ``TieredScanTrainer`` over a ring of two
slots against the eager one and the all-device ``ScanTrainer`` (plans
exact, the last chunk's ``x`` bit-equal, losses exact on tree), one host
sync a tiered epoch (the plan fetch), a staging slot not refilled before
its copy's event, and the reactive tiered lookup against the CPU's (one
sync for device ids with a disk tier, none for host ids, the warm
block's mapping released after its last launch); and the typed path:
tree and calibrated merge batches of the IGBH example's loader against
the CPU's with K3 once per plan item and K1 once per featured type,
block and weighted typed batches with their draw launches, no host sync
in typed sampling and collate, and rgat tree-dense train steps against
the CPU (chip_smoke.py's typed-phase helpers at a small size); and the
models: HGT's four forwards and the dense GAT's against the CPU, and no
host sync in a typed HGT step (chip_smoke.py's models-phase helpers at a
small size); and typed link batches (binary and triplet tree, calibrated
binary merge) against the CPU's with no host sync, the typed
materializer's passes and refresh against the CPU's, and ``sample_prob``
against the CPU's; and the distributed loader over four shards on one
card against the CPU's, with K3 P x hops and K1 3P a batch and the host
syncs exactly its counted verdict reads; the negative kernel's shard-local
entry against its plain version (owned-row counts past 65,536, an empty
shard, strict and not, host and device keys) with no host sync; a
distributed link batch with no host sync, equal to the CPU's; and a
captured typed ``DistScanTrainer`` against the eager one; and the remote
stack: spawned sampling workers on the card (the dataset shared by CUDA
IPC) against the parent's sampler at each worker's seed, their launch
counts through ``worker_metrics()``, and a card batch through
``output_to_message`` -> ``ShmChannel`` -> ``message_to_data`` bit for
bit, and the spawned ``feature_mp`` example's stderr free of torch's
report of unreleased CUDA IPC handles; and the chunk-staged remote scan:
a captured ``RemoteScanTrainer`` epoch against an eager one from a
common state at each chunk start (one upload a chunk, the first chunk
eager, then one replay a chunk), a replayed epoch with no host sync, the
remote stager's pinned slot not refilled before its copy's event, and
block frames built on a server's RPC threads from eight client threads
with the launch counters exact; and every single-device kernel entry
leaving the calling thread's current device as it was.
"""
import contextlib
import copy
import gc
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA GPU (the kernels have no CPU mode)')
  return torch.device('cuda')


# K1's edges: rows of 1, 4, 25, 100, 128, 129 and 1024 f32 (1, 2 and 4
# rows a warp at once, a row wider than a lane's vectors, the 4/8/16-byte
# routes), bf16 at 1, 100 and 101 (the 2/8/2-byte routes), f16 3, int32 128
_K1_WIDTHS = [(torch.float32, w) for w in (1, 4, 25, 100, 128, 129, 1024)] + [
    (torch.bfloat16, 1), (torch.bfloat16, 100), (torch.bfloat16, 101),
    (torch.float16, 3), (torch.int32, 128)]
# id counts: one id, under and over a warp's 32 lanes, several groups a
# warp, and one above the persistent grid's rows a pass (every warp one
# group of rows)
_K1_IDS = [1, 31, 33, 4099, 'pass+1']


def _k1_ids(n_ids, table, n, id_dtype, gen, cuda):
  """``n_ids`` ids in ``[-5, n + 5)`` (clamped by the kernel); 'pass+1'
  is one group of rows for each warp of ``table``'s persistent grid,
  plus one."""
  if n_ids == 'pass+1':
    probe = torch.zeros(1, dtype=id_dtype, device=cuda)
    shape = ops.gather.gather_rows_shape(table, probe)
    n_ids = shape['grid_warps'] * shape['rows_per_group'] + 1
  return torch.randint(-5, n + 5, (n_ids,), generator=gen).to(id_dtype).to(
      cuda)


@pytest.mark.parametrize('dtype,width', _K1_WIDTHS)
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('n_ids', _K1_IDS)
def test_gather_rows_kernel_matches_plain(cuda, dtype, width, id_dtype,
                                          n_ids):
  """K1 against its plain version, bit for bit, ids clamped; one launch,
  none for no ids."""
  gen = torch.Generator().manual_seed(width)
  n = 1000
  table = (torch.randn((n, width), generator=gen) * 100).to(dtype).to(cuda)
  ids = _k1_ids(n_ids, table, n, id_dtype, gen, cuda)
  before = ops.launch_counts()['gather_rows']
  got = ops.gather_rows_hbm(table, ids)
  torch.cuda.synchronize()
  assert torch.equal(got, ops.gather_rows_plain(table, ids))
  assert ops.launch_counts()['gather_rows'] == before + 1
  empty = ops.gather_rows_hbm(table, ids[:0])
  assert empty.shape == (0, width)
  assert ops.launch_counts()['gather_rows'] == before + 1


def _k1_entry(entry, table, cuda):
  """``table`` as K1's ``entry`` reads it: the tensor itself ('one') or
  three row blocks on the card (``ShardedRows``, the sharded entry), and
  the plain version of that read."""
  if entry == 'one':
    return table, ops.gather_rows_plain
  r = table.shape[0] // 3
  rows = ops.ShardedRows([table[i * r:(i + 1) * r].clone() for i in range(3)],
                         cuda)
  return rows, lambda _, ids: ops.gather_rows_sharded_plain(rows.shards, ids)


def _k1_launches(entry):
  return ops.launch_counts()['gather_rows' if entry == 'one' else
                             'gather_rows_sharded']


@pytest.mark.parametrize('entry', ['one', 'sharded'])
@pytest.mark.parametrize('dtype,width', [
    (torch.float32, 100), (torch.float32, 128), (torch.bfloat16, 100),
    (torch.float16, 3), (torch.int32, 128)])
def test_gather_rows_kernel_on_a_view_off_by_one_element(cuda, entry, dtype,
                                                         width):
  """A table (each block, sharded) whose base lies one element past an
  allocation's: the narrow vector routes (4 or 2 bytes), bit for bit."""
  gen = torch.Generator().manual_seed(width)
  n = 999
  flat = (torch.randn((n * width + 1,), generator=gen) * 100).to(dtype).to(
      cuda)
  table = flat[1:].view(n, width)
  if entry == 'sharded':
    r = n // 3
    blocks = []
    for i in range(3):
      b = torch.empty((r * width + 1,), dtype=dtype, device=cuda)
      b[1:] = table[i * r:(i + 1) * r].reshape(-1)
      blocks.append(b[1:].view(r, width))
    rows = ops.ShardedRows(blocks, cuda)
    assert ops.peer.bases_or(blocks) % 16 == flat.element_size()
  else:
    rows = table
    assert table.data_ptr() % 16 == flat.element_size()
  ids = torch.randint(-5, n + 5, (4099,), generator=gen).to(cuda)
  shape = ops.gather.gather_rows_shape(rows, ids)
  assert shape['vector_bytes'] == flat.element_size(), shape
  before = _k1_launches(entry)
  got = ops.gather_rows_hbm(rows, ids)
  torch.cuda.synchronize()
  assert torch.equal(got, ops.gather_rows_plain(table, ids))
  assert _k1_launches(entry) == before + 1


@pytest.mark.parametrize('entry', ['one', 'sharded'])
def test_gather_rows_kernel_past_4gib(cuda, entry):
  """A table (each block, sharded) and an output over 2**32 bytes, ids
  near the table's end: the row and output offsets need 64 bits."""
  width = 1024                                  # int32: 4 KiB rows
  rows_4g = 2 ** 32 // (width * 4)
  r = rows_4g + 64                              # each block past 4 GiB
  n = r * (1 if entry == 'one' else 2)
  blocks = [torch.empty((r, width), dtype=torch.int32, device=cuda)
            for _ in range(n // r)]
  gen = torch.Generator().manual_seed(7)
  for b in blocks:                              # the last 256 rows of each
    b[-256:] = torch.randint(-2 ** 31, 2 ** 31 - 1, (256, width),
                             generator=gen, dtype=torch.int32).to(cuda)
  ends = torch.cat([torch.arange((i + 1) * r - 256, (i + 1) * r)
                    for i in range(len(blocks))])
  # the output's 4 GiB mark falls inside its last rows
  ids = ends[torch.randint(0, ends.numel(), (rows_4g + 64,), generator=gen)]
  ids[-1] = n + 3                               # clamped to the last row
  ids = ids.to(cuda)
  table = blocks[0] if entry == 'one' else ops.ShardedRows(blocks, cuda)
  before = _k1_launches(entry)
  got = ops.gather_rows_hbm(table, ids)
  torch.cuda.synchronize()
  assert _k1_launches(entry) == before + 1
  assert got.numel() * 4 > 2 ** 32
  idx = ids.clamp(0, n - 1)
  want = blocks[0][idx] if entry == 'one' else \
      ops.gather_rows_sharded_plain(blocks, ids)
  assert torch.equal(got, want)
  del got, want, blocks, table
  torch.cuda.empty_cache()


@pytest.mark.parametrize('entry', ['one', 'sharded'])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
def test_gather_rows_kernel_captured_replays_new_ids(cuda, entry, id_dtype):
  """K1 captured into a CUDA graph: each replay reads the ids as they are
  then (changed in place between replays), bit for bit."""
  gen = torch.Generator().manual_seed(11)
  n = 3000
  table = (torch.randn((n, 100), generator=gen) * 100).to(cuda)
  rows, plain = _k1_entry(entry, table, cuda)
  ids = torch.randint(-5, n + 5, (40_000,), generator=gen).to(id_dtype).to(
      cuda)
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):
    ops.gather_rows_hbm(rows, ids)              # warm-up, outside capture
  torch.cuda.current_stream().wait_stream(stream)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = ops.gather_rows_hbm(rows, ids)
  before = _k1_launches(entry)
  for seed in range(3):
    new = torch.randint(-5, n + 5, (ids.numel(),),
                        generator=torch.Generator().manual_seed(seed))
    ids.copy_(new.to(id_dtype).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, plain(table, ids))
  assert _k1_launches(entry) == before          # replays launch no wrapper


def _hop_graph(cuda, k):
  rng = np.random.default_rng(k)
  n, e = 300, 20000
  rows = rng.integers(0, n - 1, e)
  rows[:900] = 3                      # a hub of degree above 900
  ei = np.stack([rows, rng.integers(0, n, e)])
  g = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device=cuda)
  seeds = torch.as_tensor(rng.integers(0, n, 777).astype(np.int32))
  seeds[:4] = 3
  seeds[4] = n - 1                    # degree 0
  mask = torch.as_tensor(rng.random(777) < 0.9)
  return g, seeds.to(cuda), mask.to(cuda)


@pytest.mark.parametrize('k', [5, 12, 40, 3])
def test_sample_hop_kernel_matches_plain(cuda, k):
  """The fused hop (one launch) against its plain version on the same
  device key, with and without the row table; a host key
  gives the same bytes as the device key, two calls the same bytes, and
  the CPU's plain hop the same ids."""
  g, seeds, mask = _hop_graph(cuda, k)
  key = gtt.random.fold_in(gtt.random.PRNGKey(5), k)
  dkey = gtt.random.to_device(key, cuda)
  before = ops.launch_counts()['sample_hop']
  got = ops.sample_hop_fused(g.indptr, g.indices, None, seeds, mask, k, dkey,
                             meta=g.csr_meta)
  torch.cuda.synchronize()
  assert ops.launch_counts()['sample_hop'] == before + 1
  ref = ops.uniform_sample(g.indptr, g.indices, seeds, mask, k, dkey,
                           meta=g.csr_meta)
  cpu = ops.uniform_sample(g.indptr.cpu(), g.indices.cpu(), seeds.cpu(),
                           mask.cpu(), k, key, meta=g.csr_meta.cpu())
  others = (
      ops.sample_hop_fused(g.indptr, g.indices, None, seeds, mask, k, key,
                           meta=g.csr_meta),
      ops.sample_hop_fused(g.indptr, g.indices, None, seeds, mask, k, dkey),
      ops.sample_hop_fused(g.indptr, g.indices, None, seeds, mask, k, dkey,
                           meta=g.csr_meta))
  torch.cuda.synchronize()
  for i, name in enumerate(('nbrs', 'epos', 'mask')):
    a = got[i]
    assert a.dtype == ref[i].dtype and torch.equal(a, ref[i]), name
    assert torch.equal(a.cpu(), cpu[i]), name
    for o in others:
      assert torch.equal(a, o[i]), name
  empty = ops.sample_hop_fused(g.indptr, g.indices, None, seeds[:0],
                               mask[:0], k, dkey, meta=g.csr_meta)
  assert all(t.shape == (0, k) for t in empty)


def _level_inputs(cuda, case, seed=0):
  """A graph with a hub (node 3) and a deg-0 node (n-1); a batch state
  whose buffer holds a prefix of up to 700 ids (every id of the
  adjacency for 'found'); one level's frontier."""
  rng = np.random.default_rng(seed)
  n, e = 5000, 200_000
  rows = rng.integers(0, n - 1, e)
  rows[:5000] = 3
  cols = rng.integers(0, 400 if case == 'dups' else n, e)
  g = gtt.data.Graph(gtt.data.Topology(np.stack([rows, cols]),
                                       num_nodes=n), device=cuda)
  f, k = {'empty': (0, 5), 'wide': (4096, 15)}.get(case, (1500, 10))
  seeds = rng.integers(0, n, f).astype(np.int32)
  seeds[:2] = [3, n - 1][:f]
  smask = rng.random(f) < (0.0 if case == 'masked' else 0.95)
  prefix = (np.unique(cols) if case == 'found' else
            rng.permutation(n)[:700]).astype(np.int32)
  pmask = np.arange(prefix.size) < (prefix.size if case == 'found' else 600)
  cap = prefix.size + 60_000
  state, _, _, _ = ops.init_node_merge(torch.as_tensor(prefix),
                                       torch.as_tensor(pmask), cap)
  state = ops.MergeInducerState(*(t.to(cuda) for t in state))
  src = torch.arange(f, dtype=torch.int32, device=cuda)
  return (g, torch.as_tensor(seeds).to(cuda), torch.as_tensor(smask).to(cuda),
          k, state, src, prefix.size)


def _clone(state):
  return ops.MergeInducerState(*(t.clone() for t in state))


@pytest.mark.parametrize('case', ['empty', 'masked', 'found', 'dups',
                                  'wide', 'hubs'])
@pytest.mark.parametrize('max_new', [None, 300])
def test_sample_level_kernel_matches_plain(cuda, case, max_new):
  """The fused level (a fresh scratch: one begin and three launches)
  against its plain version on the same device key, on every output,
  the node buffer and the count; two calls give the same bytes."""
  g, seeds, smask, k, state, src, c = _level_inputs(cuda, case)
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(4), 0),
                             cuda)
  kw = dict(meta=g.csr_meta, prefix_cap=c, max_new=max_new)
  before = ops.launch_counts()['sample_level']
  runs = [ops.sample_level_fused(g.indptr, g.indices, None, seeds, smask, k,
                                 key, _clone(state), src, **kw)
          for _ in range(2)]
  torch.cuda.synchronize()
  assert ops.launch_counts()['sample_level'] == before + 2 * 4
  ref = ops.sample_level_fused_plain(g.indptr, g.indices, seeds, smask, k,
                                     key, _clone(state), src, **kw)
  for st, out, ep, mk in runs:
    for name in ('nodes', 'num_nodes'):
      assert torch.equal(getattr(st, name), getattr(ref[0], name)), name
    for name in ref[1]:
      assert torch.equal(out[name], ref[1][name]), name
    assert torch.equal(ep, ref[2]) and torch.equal(mk, ref[3])
  num_new = int(runs[0][1]['num_new'])
  if case == 'wide':
    assert seeds.numel() * k > 32768
  if case in ('masked', 'found', 'empty'):
    assert num_new == 0
  if max_new and case in ('dups', 'wide', 'hubs'):
    assert num_new > max_new               # truncated


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_sampler_on_card_matches_cpu(cuda, mode):
  """Three batches of the sampler on the card (one upload of the hop keys
  per batch; the merge levels over one scratch, begun once per batch)
  equal the CPU sampler's, and launch each hop's kernel once (tree) or
  three times per level plus once per batch (merge). After the first
  (which builds the kernels), a batch from host seeds makes no host
  sync: its seeds and mask go up from pinned memory."""
  rng = np.random.default_rng(2)
  n = 2000
  ei = np.stack([rng.integers(0, n, 40_000), rng.integers(0, 600, 40_000)])
  topo = gtt.data.Topology(ei, num_nodes=n)
  dedup = 'tree' if mode == 'tree' else 'auto'
  caps = None if mode == 'tree' else [300, 1200, 2400]
  samplers = [gtt.sampler.NeighborSampler(
      gtt.data.Graph(topo, device=dev), [8, 4, 3], device=dev, seed=5,
      dedup=dedup, frontier_caps=caps) for dev in (cuda, 'cpu')]
  ops.reset_launch_counts()
  for i in range(3):
    inp = gtt.sampler.NodeSamplerInput(rng.integers(0, n, 60))
    torch.cuda.synchronize()
    with _no_sync_allowed() if i else contextlib.nullcontext():
      a = samplers[0].sample_from_nodes(inp, batch_cap=64)
    b = samplers[1].sample_from_nodes(inp, batch_cap=64)
    for name in ('node', 'num_nodes', 'row', 'col', 'edge_mask'):
      assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert [int(x) for x in a.num_sampled_nodes] == \
        [int(x) for x in b.num_sampled_nodes]
  counts = ops.launch_counts()
  if mode == 'tree':
    assert counts['sample_hop'] == 3 * 3 and counts['sample_level'] == 0
  else:
    assert counts['sample_level'] == 3 * (3 * 3 + 1)
    assert counts['sample_hop'] == 0


def test_sample_level_fused_on_card_matches_cpu_route(cuda):
  """Two merge levels on the card (kernel route, one scratch begun once)
  against the CPU route (JAX fallback): nodes, counts and every output
  equal; the sorted view is not compared (the kernel route leaves it
  stale, as on the TPU). The card route makes no host sync (torch's sync
  debug mode raises on one), the host keys' upload included."""
  rng = np.random.default_rng(9)
  n = 3000
  ei = np.stack([rng.integers(0, n, 60_000), rng.integers(0, 900, 60_000)])
  g = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device=cuda)
  seeds = torch.as_tensor(rng.integers(0, n, 256).astype(np.int32))
  smask = torch.arange(256) < 250
  caps = [256, 1024, 2048]
  outs = {}
  keys = gtt.random.split(gtt.random.fold_in(gtt.random.PRNGKey(1), 1), 2)
  for dev in ('cpu', cuda):
    gg = g if dev == cuda else gtt.data.Graph(g.topo, device='cpu')
    s, m = seeds.to(dev), smask.to(dev)
    meta = gg.csr_meta          # built (and cached) before the checked part
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error' if dev == cuda else 'default')
    try:
      st, fr, fm, _ = ops.init_node_merge(s, m, sum(caps))
      scratch = None
      hop_keys = keys
      if dev == cuda:
        scratch = ops.LevelScratch(n, sum(caps), dev).begin(st, 256)
        hop_keys = gtt.random.to_device(keys, dev)
      fidx = torch.arange(256, dtype=torch.int32, device=dev)
      res = []
      for i, k in enumerate((10, 5)):
        st, out, _, _ = ops.sample_level_fused(
            gg.indptr, gg.indices, None, fr, fm, k, hop_keys[i], st, fidx,
            meta=meta, prefix_cap=sum(caps[:i + 1]),
            max_new=caps[i + 1], final=(i == 1), scratch=scratch)
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


def _runs_ids(case, n, gen, span=8):
  """Ids for the gather-v2 cases: random ids, a contiguous stretch (full
  runs) and out-of-range ids on both sides, 1,000 of them (not a
  multiple of block_rows=256), unless the case says otherwise; the run
  cases write their stretch at slot 300 of such ids."""
  if case == 'empty':
    return torch.zeros(0, dtype=torch.int32)
  if case == 'table-end':
    return torch.arange(n - 300, n + 5, dtype=torch.int32)
  if case == 'all-equal':
    return torch.full((777,), 13, dtype=torch.int32)
  ids = torch.cat([torch.randint(-5, n + 5, (600,), generator=gen),
                   torch.arange(1000, 1400)])
  ids = ids[torch.randperm(ids.numel(), generator=gen)]
  if case == 'presorted':
    ids = ids.clamp(0, n - 1).sort().values
  stretch = {'run-span': span, 'run-span-minus-1': span - 1,
             'run-3span-plus-1': 3 * span + 1}.get(case)
  if stretch is not None:
    ids[299] = 0
    ids[300:300 + stretch] = torch.arange(2000, 2000 + stretch)
    ids[300 + stretch] = 0
  if case == 'tile-cross':     # over the tile edge at slot 256
    ids[256 - 20:256 + 20] = torch.arange(3000, 3040)
  if case == 'run-to-end':     # a run ending on row N - 1, then clamped ids
    ids[500:540] = torch.arange(n - 32, n + 8)
  return ids.to(torch.int64 if case == 'int64' else torch.int32)


_RUN_CASES = ['empty', 'ragged', 'table-end', 'all-equal', 'int64',
              'presorted', 'run-span', 'run-span-minus-1', 'run-3span-plus-1',
              'tile-cross', 'run-to-end']
_ROW_TYPES = [(torch.float32, 47), (torch.float32, 100),
              (torch.float32, 128), (torch.bfloat16, 47),
              (torch.bfloat16, 100), (torch.bfloat16, 128),
              (torch.int32, 47), (torch.int32, 100), (torch.int32, 128)]


@pytest.mark.parametrize('case,dtype,width,grid,view', [
    (case, dtype, width, (256, 8), 'whole')
    for case in _RUN_CASES for dtype, width in _ROW_TYPES] + [
    ('ragged', torch.float32, 47, (16, 4), 'whole'),
    ('presorted', torch.bfloat16, 128, (16, 4), 'whole'),
    ('tile-cross', torch.float32, 100, (1024, 8), 'whole'),
    ('run-3span-plus-1', torch.float32, 47, (1, 8), 'whole'),
    ('ragged', torch.float32, 47, (256, 1), 'whole'),
    ('ragged', torch.float32, 47, (256, 8), 'offset'),
    ('run-3span-plus-1', torch.float32, 47, (256, 8), 'offset'),
    ('tile-cross', torch.bfloat16, 47, (256, 8), 'offset')])
def test_gather_runs_kernel_matches_plain(cuda, case, dtype, width, grid,
                                          view):
  """The kernel against the plain version and table[clip(ids)], and its
  own plan (read back through plan_out) against plan_runs_in_tiles. The
  'offset' view is table[1:] of a contiguous table, whose rows are not
  16-byte aligned at width 47."""
  gen = torch.Generator().manual_seed(width)
  n = 5000
  table = (torch.randn((n + 1, width), generator=gen) * 100).to(dtype)
  table = table.to(cuda)
  table = table[1:] if view == 'offset' else table[:n]
  br, rs = grid
  ids = _runs_ids(case, n, gen, rs).to(cuda)
  pre = case == 'presorted'
  before = ops.launch_counts()['gather_runs']
  got = ops.gather_rows_hbm2(table, ids, br, rs, presorted=pre)
  torch.cuda.synchronize()
  assert got.shape == (ids.numel(), width) and got.dtype == dtype
  assert torch.equal(got, ops.gather_rows_hbm2_plain(table, ids, br, rs,
                                                     presorted=pre))
  assert torch.equal(got, ops.gather_rows_plain(table, ids))
  assert ops.launch_counts()['gather_runs'] == before + (case != 'empty')
  plan = torch.full((ids.numel(),), -1, dtype=torch.int32, device=cuda)
  again = ops.gather._gather_runs_launch(table, ids, br, rs, plan_out=plan)
  torch.cuda.synchronize()
  assert torch.equal(again, got)
  want = ops.plan_runs_in_tiles(ids.cpu(), n, br, rs)
  assert torch.equal(plan.cpu(), want)
  kind = ops.decode_gather_plan(want)[0]
  if case in ('run-span', 'run-3span-plus-1', 'tile-cross', 'run-to-end',
              'table-end') and rs > 1 and br > 1:
    assert bool((kind == 1).any())


def test_gather_rows_hbm2_is_one_device_kernel(cuda):
  """A gather_rows_hbm2 call on a CUDA table runs exactly one device
  kernel (no sort, no plan ops), as torch.profiler sees the device."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  gen = torch.Generator().manual_seed(3)
  table = torch.randn((5000, 47), generator=gen).to(cuda)
  ids = _runs_ids('ragged', 5000, gen).to(cuda)
  ops.gather_rows_hbm2(table, ids)          # built and loaded before
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    got = ops.gather_rows_hbm2(table, ids)
    torch.cuda.synchronize()
  device = [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]
  assert len(device) == 1 and 'gather_runs' in device[0], device
  assert torch.equal(got, ops.gather_rows_plain(table, ids))


def test_routed_store_lookup_launches_gather_runs(cuda):
  """A routed EmbeddingStore.lookup over a [N, 47] f32 table is one
  gather-v2 launch; pad slots come back zero."""
  from graphlearn_tpu_torch.serving import EmbeddingStore
  gen = torch.Generator().manual_seed(1)
  table = torch.randn((500, 47), generator=gen).to(cuda)
  store = EmbeddingStore(table, num_nodes=490)
  store.set_kernel_routing(use_pallas_v2=True, block_rows=256, run_span=8)
  ids = np.full(64, -1, np.int32)
  ids[:50] = np.concatenate([np.arange(100, 130), np.arange(400, 420)])
  mask = ids >= 0
  before = ops.launch_counts()
  rows = store.fetch(store.lookup(ids, mask))
  after = ops.launch_counts()
  assert after['gather_runs'] == before['gather_runs'] + 1
  assert after['gather_rows'] == before['gather_rows']
  want = np.where(mask[:, None], table.cpu().numpy()[np.maximum(ids, 0)], 0)
  np.testing.assert_array_equal(rows, want)


def test_materialize_on_card_matches_cpu(cuda):
  """A small materialization and refresh on the card against the CPU
  route (the neighbour gather is the row-gather kernel on the card)."""
  from graphlearn_tpu_torch.serving import EmbeddingMaterializer
  rng = np.random.default_rng(4)
  n = 300
  ei = rng.integers(0, n, (2, 2400))
  feats = rng.standard_normal((n, 10)).astype(np.float32)
  outs = {}
  for dev in ('cpu', cuda):
    ds = gtt.data.Dataset(device=dev)
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feats)
    model = gtt.models.GraphSAGE(10, 16, 5, num_layers=3, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    mat = EmbeddingMaterializer(ds, model, block_size=64, chunk_size=2)
    before = ops.launch_counts()['gather_rows']
    emb = mat.materialize().cpu()
    launched = ops.launch_counts()['gather_rows'] - before
    outs[str(dev)] = (emb, mat.refresh_rows([0, 5, n - 1]), launched)
  torch.testing.assert_close(outs[str(cuda)][0], outs['cpu'][0],
                             rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(outs[str(cuda)][1], outs['cpu'][1],
                             rtol=1e-4, atol=1e-5)
  # one row gather per block and layer: 3 layers x 5 blocks of 64
  assert outs['cpu'][2] == 0 and outs[str(cuda)][2] == 3 * 5


@pytest.mark.parametrize('dtype,width,n_ids,view', [
    (torch.float32, 128, 153_600, 'whole'), (torch.float32, 100, 4099, 'whole'),
    (torch.bfloat16, 47, 777, 'whole'), (torch.int32, 600, 33, 'whole'),
    (torch.float32, 8, 0, 'whole'), (torch.float32, 1024, 3001, 'whole'),
    (torch.float32, 128, 5000, 'offset')])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
def test_row_gather_probe_kernel_matches_plain(cuda, dtype, width, n_ids,
                                               view, id_dtype):
  """Both routes of the probe's row gather against the plain version and
  K1: the bulk route (rows of a multiple of 16 bytes on 16-byte aligned
  pointers, 1024 f32 being two bulk copies a row) and the vector route
  (47 bf16 rows, and a table view 4 bytes past a 16-byte boundary); one
  launch counted on the route the shape picks."""
  gen = torch.Generator().manual_seed(width)
  n = 5000
  table = (torch.randn((n * width + 1,), generator=gen) * 100).to(dtype)
  table = table.to(cuda)
  table = (table[1:] if view == 'offset' else table[:n * width]).view(
      n, width)
  if view == 'offset':
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
  ids = torch.randint(-5, n + 5, (n_ids,), generator=gen).to(id_dtype)
  ids = ids.to(cuda)
  route = ops.row_gather_route(table)
  assert route == ('bulk' if (width * table.element_size()) % 16 == 0 and
                   view == 'whole' else 'vector')
  before = ops.launch_counts()
  got = ops.row_gather_probe(table, ids)
  torch.cuda.synchronize()
  assert got.shape == (n_ids, width)
  assert torch.equal(got, ops.row_gather_probe_plain(table, ids))
  assert torch.equal(got, ops.gather_rows_hbm(table, ids))
  after = ops.launch_counts()
  name = f'row_gather_probe_{route}'
  other = 'row_gather_probe_vector' if route == 'bulk' else \
      'row_gather_probe_bulk'
  assert after[name] == before[name] + (n_ids > 0)
  assert after[other] == before[other]


@pytest.mark.parametrize('n_steps', [1, 3, 8])
@pytest.mark.parametrize('count', [0, 1, 2 ** 31 - 2, 2 ** 32 - 1,
                                   2 ** 32 + 5])
def test_step_keys_kernel_matches_plain(cuda, n_steps, count):
  """The chunk's hop keys from a device counter: exact against
  ``random.step_keys_plain`` (counts past 2**31 and 2**32 wrap as the
  JAX int32 count does); one launch, no host sync."""
  base = gtt.random.fold_in(gtt.random.PRNGKey(7), 3)
  dbase = gtt.random.to_device(base, cuda)
  counter = torch.full((), count, dtype=torch.int64, device=cuda)
  before = ops.launch_counts()['step_keys']
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = ops.step_keys(dbase, counter, n_steps, 3)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  torch.cuda.synchronize()
  assert ops.launch_counts()['step_keys'] == before + 1
  want = gtt.random.step_keys_plain(
      base, count + torch.arange(n_steps, dtype=torch.int64), 3)
  assert got.shape == (n_steps, 3, 2) and torch.equal(got.cpu(), want)
  assert torch.equal(got, gtt.random.step_keys_plain(
      dbase, counter + torch.arange(n_steps, device=cuda), 3))


def _scan_pair(cuda, mode, chunk):
  """Two ScanTrainers from one start, captured and eager, over a small
  graph: 4 steps of 48 seeds (the last ragged) in chunks of ``chunk``."""
  from graphlearn_tpu_torch.models import train
  torch.backends.cuda.matmul.allow_tf32 = False
  rng = np.random.default_rng(13)
  n, f, c, fanouts, b = 2000, 16, 5, [5, 4], 48
  ei = np.stack([rng.integers(0, n, 30000), rng.zipf(1.5, 30000) % n])
  ds = gtt.data.Dataset(device=cuda)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(rng.standard_normal((n, f)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, c, n))
  pool = rng.permutation(n)[:3 * b + 20]
  # unclamped merge: the clamped guard's epoch-end check is a host sync
  caps = None
  if mode == 'merge':
    no, eo = train.merge_hop_offsets(b, fanouts, frontier_caps=caps)
  else:
    no, eo = train.tree_hop_offsets(b, fanouts)
  out = []
  for capture in (True, False):
    loader = gtt.loader.NeighborLoader(
        ds, fanouts, pool, batch_size=b, shuffle=True, seed=3,
        dedup=mode, frontier_caps=caps, device=cuda)
    model = gtt.models.GraphSAGE(
        f, 32, c, num_layers=2, hop_node_offsets=no, hop_edge_offsets=eo,
        tree_dense=mode == 'tree', merge_dense=mode == 'merge',
        fanouts=fanouts, device=cuda,
        generator=torch.Generator().manual_seed(0))
    out.append((gtt.loader.ScanTrainer(loader, model, c, chunk_size=chunk,
                                       capture=capture),
                train.create_train_state(model)))
  return out


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_scan_trainer_captured_matches_eager(cuda, mode):
  """The captured ScanTrainer (one CUDA graph per chunk length) against
  the eager one from the same start, over three epochs of 4 steps in
  chunks of 3 (a tail chunk of 1): the first chunk is the eager warm-up,
  the tail and the full chunk are captured once each and replayed with
  new keys; the seed matrices and the graphs' hop keys are exact, losses
  and parameters within rtol 1e-4 (the backward's scatter atomics sum in
  no fixed order), the launch counters equal the eager epoch's, and the
  third epoch (replays only) makes no host sync."""
  (cap, cstate), (eag, estate) = _scan_pair(cuda, mode, 3)
  assert cap.capture and not eag.capture
  assert cstate.optimizer.param_groups[0]['capturable']
  graphs = None
  for epoch in range(3):
    count0 = cap._sampler._call_count + 1
    counts = {}
    for name, t, st in (('cap', cap, cstate), ('eag', eag, estate)):
      ops.reset_launch_counts()
      if name == 'cap' and epoch == 2:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
      try:
        st, losses, accs = t.run_epoch(st)
      finally:
        torch.cuda.set_sync_debug_mode('default')
      torch.cuda.synchronize()
      counts[name] = ops.launch_counts()
      if name == 'cap':
        cstate, closs, cacc = st, losses, accs
      else:
        estate, eloss, eacc = st, losses, accs
    seeds = [t._epoch_seeds(gtt.random.fold_in(t._perm_key, epoch), 4)
             for t in (cap, eag)]
    assert all(torch.equal(a, b) for a, b in zip(*seeds))
    assert counts['cap'] == counts['eag']
    assert counts['cap']['step_keys'] == 2
    torch.testing.assert_close(closs, eloss, rtol=1e-4, atol=0)
    torch.testing.assert_close(cacc, eacc, rtol=1e-4, atol=0)
    assert cstate.step == estate.step == 4 * (epoch + 1)
    # the graphs' hop keys hold the epoch's last chunk of each length
    want = gtt.random.step_keys_plain(
        cap._sampler._key, count0 + torch.arange(4, dtype=torch.int64), 2)
    if 1 in cap._graphs:
      assert torch.equal(cap._graphs[1].keys.cpu(), want[3:])
    if 3 in cap._graphs:
      assert torch.equal(cap._graphs[3].keys.cpu(), want[:3])
    assert cap._static['seeds'][:1].equal(seeds[0][0][3:])
    if epoch == 1:
      graphs = {k: id(g.graph) for k, g in cap._graphs.items()}
      assert sorted(graphs) == [1, 3]
  assert {k: id(g.graph) for k, g in cap._graphs.items()} == graphs
  assert cap._sampler._call_count == eag._sampler._call_count == 12
  for a, b in zip(cap.model.parameters(), eag.model.parameters()):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_scan_trainer_recaptures_for_a_new_state(cuda, mode):
  """A captured chunk freezes the optimizer's tensors and rate: given
  another Adam state between epochs (a loaded one at another rate, then
  a fresh ``TrainState``), the captured trainer drops its graphs, warms
  up eagerly and captures again, and stays with the eager trainer given
  the same states (losses within rtol 1e-4, equal launch counts)."""
  from graphlearn_tpu_torch.models import train
  (cap, cstate), (eag, estate) = _scan_pair(cuda, mode, 3)
  cstate, _, _ = cap.run_epoch(cstate)
  estate, _, _ = eag.run_epoch(estate)
  eag.model.load_state_dict(cap.model.state_dict())
  loaded = copy.deepcopy(cstate.optimizer.state_dict())
  for st in loaded['state'].values():
    st['exp_avg'].mul_(-0.5)
  loaded['param_groups'][0]['lr'] = 1e-3
  for epoch in range(3):
    graphs = {k: g.graph for k, g in cap._graphs.items()}
    if epoch == 0:
      for st in (cstate, estate):
        st.optimizer.load_state_dict(copy.deepcopy(loaded))
    elif epoch == 1:
      cstate = train.create_train_state(cap.model, lr=2e-3)
      estate = train.create_train_state(eag.model, lr=2e-3)
    counts = {}
    ops.reset_launch_counts()
    cstate, closs, _ = cap.run_epoch(cstate)
    counts['cap'] = ops.launch_counts()
    ops.reset_launch_counts()
    estate, eloss, _ = eag.run_epoch(estate)
    counts['eag'] = ops.launch_counts()
    torch.cuda.synchronize()
    assert counts['cap'] == counts['eag']
    torch.testing.assert_close(closs, eloss, rtol=1e-4, atol=0)
    for a, b in zip(cap.model.parameters(), eag.model.parameters()):
      torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    new = {k: g.graph for k, g in cap._graphs.items()}
    # a new state: the first chunk is the warm-up, the tail is captured
    # again; the same state: the tail's graph is replayed
    assert sorted(graphs) == [1] and \
        sorted(new) == ([1] if epoch < 2 else [1, 3])
    assert (new[1] is graphs[1]) == (epoch == 2), epoch


@pytest.mark.parametrize('cluster', [2, 4, 8])
@pytest.mark.parametrize('tn,shape,view', [
    (65_536, (6144, 128), 'whole'),  # the probe's shape
    (65_536, (3001,), 'whole'),      # not a multiple of the cluster's tile
    (65_535, (999, 7), 'whole'),     # an odd table: unequal parts
    (65_537, (4099,), 'whole'),      # TN not a multiple of any cluster
    (3, (50,), 'whole'),             # TN below the cluster size
    (1, (50,), 'whole'), (116_224, (2 ** 16 + 3,), 'whole'),
    (40, (0,), 'whole'), (40, (3,), 'whole'),
    (65_536, (6143,), 'offset'),     # ids 4 bytes past a 16-byte boundary
    (1001, (2,), 'offset')])
def test_smem_take_kernel_matches_plain(cuda, cluster, tn, shape, view):
  gen = torch.Generator().manual_seed(tn)
  table = torch.randint(0, 2 ** 30, (tn,), generator=gen,
                        dtype=torch.int32).to(cuda)
  numel = int(np.prod(shape))
  idx = torch.randint(0, tn, (numel + 1,), generator=gen, dtype=torch.int32)
  flat = idx[1:] if view == 'offset' else idx[:numel]
  if flat.numel():
    # out of range above and below (fill), and negative ids that wrap
    flat[::97] = tn
    flat[1::89] = -tn - 1
    flat[2::83] = -1
    flat[3::79] = -tn
    flat[4::73] = 2 ** 31 - 1
    flat[5::71] = -2 ** 31
  idx = idx.to(cuda)
  idx = (idx[1:] if view == 'offset' else idx[:numel]).view(shape)
  if view == 'offset':
    assert idx.data_ptr() % 16 != 0 and idx.is_contiguous()
  before = ops.launch_counts()['smem_take']
  got = ops.smem_take(table, idx, cluster=cluster)
  torch.cuda.synchronize()
  ref = ops.smem_take_plain(table, idx)
  assert got.shape == idx.shape and got.dtype == torch.int32
  assert torch.equal(got, ref)
  if flat.numel():
    assert int((got == ops.probes.FILL).sum()) > 0
  assert ops.launch_counts()['smem_take'] == before + (idx.numel() > 0)


def test_smem_take_holds_the_largest_table_of_each_cluster(cuda):
  for cluster in ops.probes.SMEM_TAKE_CLUSTERS:
    tn = cluster * 232_448 // 4
    table = torch.arange(tn, dtype=torch.int32, device=cuda)
    idx = torch.randint(-tn, tn, (100_003,), dtype=torch.int32, device=cuda)
    got = ops.smem_take(table, idx, cluster=cluster)
    assert torch.equal(got, ops.smem_take_plain(table, idx))
    with pytest.raises(ValueError, match='cluster holds'):
      ops.smem_take(torch.zeros(tn + 1, dtype=torch.int32, device=cuda), idx,
                    cluster=cluster)


def test_smem_take_refuses_a_table_beyond_the_cluster(cuda):
  table = torch.zeros(ops.probes.SMEM_TAKE_MAX_ROWS + 1, dtype=torch.int32,
                      device=cuda)
  with pytest.raises(ValueError, match='cluster holds'):
    ops.smem_take(table, torch.zeros(4, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_train_step_on_card_matches_cpu(cuda, mode):
  from graphlearn_tpu_torch.models import train
  torch.backends.cuda.matmul.allow_tf32 = False
  rng = np.random.default_rng(11)
  n, f, c, fanouts, b = 2000, 32, 7, [5, 4, 3], 64
  ei = np.stack([rng.integers(0, n, 40000), rng.zipf(1.5, 40000) % n])
  feats = rng.standard_normal((n, f)).astype(np.float32)
  labels = rng.integers(0, c, n)
  pool = rng.permutation(n)[:3 * b]
  caps = None
  runs = {}
  for dev in (cuda, torch.device('cpu')):
    ds = gtt.data.Dataset(device=dev)
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feats)
    ds.init_node_labels(labels)
    loader = gtt.loader.NeighborLoader(
        ds, fanouts, pool, batch_size=b, dedup=mode, frontier_caps=caps,
        device=dev)
    if mode == 'merge':
      no, eo = train.merge_hop_offsets(b, fanouts, frontier_caps=caps)
    else:
      no, eo = train.tree_hop_offsets(b, fanouts)
    model = gtt.models.GraphSAGE(
        f, 64, c, num_layers=3, hop_node_offsets=no, hop_edge_offsets=eo,
        tree_dense=mode == 'tree', merge_dense=mode == 'merge',
        fanouts=fanouts, device=dev,
        generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model)
    step, _ = train.make_train_step(model, c)
    losses = []
    for batch in loader:
      state, loss, _ = step(state, train.batch_to_dict(batch))
      losses.append(loss.cpu())
    runs[dev.type] = (torch.stack(losses), model)
  torch.testing.assert_close(runs['cuda'][0], runs['cpu'][0], rtol=1e-4,
                             atol=0)
  for a, b_ in zip(runs['cuda'][1].parameters(), runs['cpu'][1].parameters()):
    torch.testing.assert_close(a.detach().cpu(), b_.detach(), rtol=1e-3,
                               atol=1e-5)


@contextlib.contextmanager
def _no_sync_allowed():
  """``set_sync_debug_mode('error')`` with the cyclic garbage collector
  off: a CUDA graph it freed in the window (an earlier test's trainer in a
  reference cycle) would synchronise to release its memory pool."""
  collecting = gc.isenabled()
  gc.disable()
  torch.cuda.set_sync_debug_mode('error')
  try:
    yield
  finally:
    torch.cuda.set_sync_debug_mode('default')
    if collecting:
      gc.enable()


STAT_KEYS = ('hits', 'misses', 'unique_misses', 'overflow', 'lookups')


@contextlib.contextmanager
def published(stores: dict):
  """``{key: counters}``: what each of ``stores``' ``publish_stats``
  published while the region ran, summed over its calls. The distributed
  loaders and trainers publish once an epoch, at its end, and clear the
  store, so an epoch's counters are read here, not from ``stats()`` after
  it. (The CPU tests import it from here: this module imports no JAX.)"""
  got = {k: dict.fromkeys(STAT_KEYS, 0) for k in stores}

  def wrap(key, plain):
    def publish_stats(*a, **kw):
      out = plain(*a, **kw)
      for k in STAT_KEYS:
        got[key][k] += out[k]
      return out
    return publish_stats

  for key, store in stores.items():
    store.publish_stats = wrap(key, store.publish_stats)
  try:
    yield got
  finally:
    for store in stores.values():
      del store.publish_stats


def _publish_let_through(loader) -> list:
  """Let the loader's epoch-end publish (its one host read a store, the
  flight record's feature fields) through a ``set_sync_debug_mode('error')``
  window; returns the list its calls are counted in."""
  calls, publish = [], loader._publish_feature_stats

  def let_through():
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('default')
    try:
      publish()
    finally:
      torch.cuda.set_sync_debug_mode(mode)
    calls.append(1)

  loader._publish_feature_stats = let_through
  return calls


class _Small:
  """A small card training set-up (4 steps of 48 seeds, the last ragged)
  whose every ``trainer(cls, ...)`` gets a fresh loader and a model from
  the same weights: the start two trainers are compared from."""

  def __init__(self, cuda, mode, shuffle=True):
    from graphlearn_tpu_torch.models import train
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    n, f, self.c, self.fanouts, self.b = 2000, 16, 5, [5, 4], 48
    ei = np.stack([rng.integers(0, n, 30000), rng.zipf(1.5, 30000) % n])
    self.ds = gtt.data.Dataset(device=cuda)
    self.ds.init_graph(ei, num_nodes=n)
    self.ds.init_node_features(rng.standard_normal((n, f)).astype(
        np.float32))
    self.ds.init_node_labels(rng.integers(0, self.c, n))
    self.pool = rng.permutation(n)[:3 * self.b + 20]
    self.cuda, self.mode, self.shuffle, self.f = cuda, mode, shuffle, f
    # unclamped merge: the clamped guard's epoch-end check is a host sync
    if mode == 'merge':
      self.offsets = train.merge_hop_offsets(self.b, self.fanouts)
    else:
      self.offsets = train.tree_hop_offsets(self.b, self.fanouts)

  def loader(self):
    return gtt.loader.NeighborLoader(
        self.ds, self.fanouts, self.pool, batch_size=self.b,
        shuffle=self.shuffle, seed=3, dedup=self.mode, device=self.cuda)

  def model(self, seed=0):
    no, eo = self.offsets
    return gtt.models.GraphSAGE(
        self.f, 32, self.c, num_layers=2, hop_node_offsets=no,
        hop_edge_offsets=eo, tree_dense=self.mode == 'tree',
        merge_dense=self.mode == 'merge', fanouts=self.fanouts,
        device=self.cuda, generator=torch.Generator().manual_seed(seed))

  def trainer(self, cls, seed=0, **kw):
    from graphlearn_tpu_torch.models import train
    model = self.model(seed)
    return cls(self.loader(), model, self.c, **kw), \
        train.create_train_state(model)


def _close_params(m1, m2):
  for a, b in zip(m1.parameters(), m2.parameters()):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_captured_crash_resume_matches_uninterrupted(cuda, mode, tmp_path):
  """A captured ScanTrainer (chunks of 1) crashed at chunk 3 and resumed
  in a fresh captured trainer from other weights: the snapshot's loss
  prefix exact, the whole epoch's losses within rtol 1e-4 of the
  uninterrupted captured epoch and the parameters close; the resumed
  trainer warms up, captures and replays its rest."""
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  s = _Small(cuda, mode)
  ref, rstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=1)
  rstate, rlosses, _ = ref.run_epoch(rstate)
  victim, vstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=1)
  ck = ChunkCheckpointer(str(tmp_path), every=2).attach(victim)

  def killer(c, start, k):
    if c == 3:
      raise RuntimeError('injected crash')

  victim.stage_hook = killer
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(vstate)
  ck.close()
  snap = ck.latest()
  assert snap.next_start == 2
  fresh, template = s.trainer(gtt.loader.ScanTrainer, seed=7, chunk_size=1)
  state, losses, _ = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  torch.cuda.synchronize()
  assert fresh.capture and sorted(fresh._graphs) == [1]
  assert state.step == 4
  np.testing.assert_array_equal(losses[:2], snap.arrays['losses'])
  torch.testing.assert_close(torch.as_tensor(losses), rlosses.cpu(),
                             rtol=1e-4, atol=0)
  _close_params(fresh.model, ref.model)
  want = gtt.random.step_keys_plain(fresh._sampler._key,
                                    torch.arange(1, 5, dtype=torch.int64), 2)
  assert torch.equal(fresh._graphs[1].keys.cpu(), want[3:])


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_checkpointed_captured_epoch_makes_no_host_sync(cuda, mode,
                                                        tmp_path):
  """A captured epoch with a checkpointer at every boundary runs under
  ``set_sync_debug_mode('error')``: the boundary copies go to pinned
  memory on the copy stream and the writer waits for them; the final
  snapshot holds the epoch's end state."""
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  s = _Small(cuda, mode)
  tr, state = s.trainer(gtt.loader.ScanTrainer, chunk_size=2)
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(tr)
  state, _, _ = tr.run_epoch(state)        # warm-up, capture, first pins
  torch.cuda.synchronize()
  with _no_sync_allowed():
    state, losses, _ = tr.run_epoch(state)
  ck.flush()
  snap = ck.latest()
  assert snap.epoch == 1 and snap.next_start == 4 and not ck.degraded
  np.testing.assert_array_equal(snap.arrays['losses'], losses.cpu().numpy())
  for n, p in tr.model.named_parameters():
    np.testing.assert_array_equal(snap.arrays[f'param:{n}'],
                                  p.detach().cpu().numpy())
    np.testing.assert_array_equal(
        snap.arrays[f'adam:{n}:step'],
        state.optimizer.state[p]['step'].cpu().numpy())
  ck.close()


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_run_trainer_captured_matches_eager_and_scan(cuda, mode):
  """A captured RunTrainer (3 epochs of 4 steps in chunks of 3: chunks
  across both boundaries) against an eager one and three captured
  ScanTrainer epochs from the same start: seed rows exact, losses within
  rtol 1e-4, the parameters close, the launch counts of the captured and
  the eager run equal, and a second captured run makes no host sync."""
  s = _Small(cuda, mode)
  runs = {}
  for name, capture in (('cap', True), ('eag', False)):
    tr, state = s.trainer(gtt.loader.RunTrainer, chunk_size=3, epochs=3,
                          capture=capture)
    if capture:
      tr._seeds_dev = torch.as_tensor(s.pool.astype(np.int32), device=cuda)
      mat, _ = tr._prologue(12)
    ops.reset_launch_counts()
    state, losses, _ = tr.run(state)
    torch.cuda.synchronize()
    runs[name] = (tr, state, losses, ops.launch_counts())
  scan, sstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=3)
  slosses = []
  for _ in range(3):
    sstate, lo, _ = scan.run_epoch(sstate)
    slosses.append(lo)
  slosses = torch.cat(slosses)
  cap, cstate, closses, ccounts = runs['cap']
  assert ccounts == runs['eag'][3] and ccounts['step_keys'] == 4
  for e in range(3):
    want, _ = scan._epoch_seeds(gtt.random.fold_in(scan._perm_key, e), 4)
    assert torch.equal(mat[4 * e:4 * e + 4], want)
  for other in (runs['eag'][2], slosses):
    torch.testing.assert_close(closses, other, rtol=1e-4, atol=0)
  _close_params(cap.model, runs['eag'][0].model)
  _close_params(cap.model, scan.model)
  assert int(cap.last_run_report['epochs_run']) == 3
  torch.cuda.synchronize()
  with _no_sync_allowed():
    cap.run(cstate)
  torch.cuda.synchronize()
  assert int(cap.last_run_report['epochs_run']) == 3


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_run_trainer_early_stop_captured(cuda, mode):
  """patience=1, min_delta=10 under capture: the run stops after epoch 2,
  the stopped tail is zeros, and the parameters and Adam's tensors at the
  step-8 boundary are the final ones bit for bit."""
  s = _Small(cuda, mode)
  tr, state = s.trainer(gtt.loader.RunTrainer, chunk_size=2, epochs=4,
                        patience=1, min_delta=10.0)
  at_stop = {}

  def grab(c, start, k):
    if start + k == 8:
      st = tr._chunk_carry['state']
      at_stop['t'] = [t.clone() for t in tr._updated_tensors(st)]

  tr.ack_hook = grab
  state, losses, accs = tr.run(state)
  torch.cuda.synchronize()
  assert tr.capture and sorted(tr._graphs) == [2]
  assert bool((losses[:8] != 0).all()) and bool((losses[8:] == 0).all())
  assert bool((accs[8:] == 0).all())
  rep = tr.last_run_report
  assert bool(rep['stopped']) and int(rep['epochs_run']) == 2
  now = tr._updated_tensors(state)
  assert len(now) == len(at_stop['t'])
  assert all(torch.equal(a, b) for a, b in zip(now, at_stop['t']))


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_overlapped_trainer_on_card_matches_loop(cuda, mode):
  """OverlappedTrainer (sampling on a second stream) against the per-step
  loop from the same start, two epochs: losses within rtol 1e-4, the
  parameters close, the sampler's counter equal."""
  from graphlearn_tpu_torch.models import train
  s = _Small(cuda, mode)
  loader, model = s.loader(), s.model()
  state = train.create_train_state(model)
  step, _ = train.make_train_step(model, s.c)
  want = []
  for _ in range(2):
    for b in loader:
      state, loss, _ = step(state, train.batch_to_dict(b))
      want.append(loss)
  tr, ostate = s.trainer(gtt.loader.OverlappedTrainer)
  losses = []
  for _ in range(2):
    ostate, lo = tr.run_epoch(ostate)
    losses += lo
  torch.cuda.synchronize()
  assert tr._side is not None and ostate.step == 8
  torch.testing.assert_close(torch.stack(losses), torch.stack(want),
                             rtol=1e-4, atol=0)
  _close_params(tr.model, model)
  assert tr._sampler._call_count == loader.sampler._call_count


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_run_trainer_captured_resume(cuda, mode, tmp_path):
  """A captured RunTrainer (2 epochs of 4 steps in chunks of 3) with a
  checkpointer at every chunk; a fresh captured trainer resumes from its
  step-6 snapshot (inside epoch 2), as after a crash there. The eval carry
  comes back from the snapshot (its int32, bool and float tensors staged
  on the card): epoch 1's metric exactly; the replayed steps' losses
  within rtol 1e-4 of the checkpointed run's own, from the same state."""
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer, snapshot
  s = _Small(cuda, mode)
  ref, rstate = s.trainer(gtt.loader.RunTrainer, chunk_size=3, epochs=2)
  ck = ChunkCheckpointer(str(tmp_path), every=1, keep=5).attach(ref)
  rstate, rlosses, _ = ref.run(rstate)
  ck.close()
  snap = snapshot.load_snapshot(snapshot.snapshot_path(str(tmp_path), 0, 6))
  assert int(snap.arrays['extra:eval:edone']) == 1
  assert snap.arrays['extra:eval:correct'].dtype == np.int32
  fresh, template = s.trainer(gtt.loader.RunTrainer, seed=5, chunk_size=3,
                              epochs=2)
  state, losses, _ = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template, snapshot=snap)
  torch.cuda.synchronize()
  assert fresh.capture and state.step == 8
  np.testing.assert_array_equal(losses[:6], snap.arrays['losses'])
  torch.testing.assert_close(torch.as_tensor(losses), rlosses.cpu(),
                             rtol=1e-4, atol=0)
  rep = fresh.last_run_report
  assert int(rep['epochs_run']) == 2 and not bool(rep['stopped'])
  assert float(rep['eval_metric'][0]) == float(
      snap.arrays['extra:eval:metrics'][0])


# ------------------------------------ the draw kernel and the other modes


@pytest.mark.parametrize('shape', [(0,), (1,), (7, 3), (153600, 5),
                                   (15360, 10), (2 ** 20 + 3,)])
def test_uniform_draw_kernel_matches_plain(cuda, shape):
  """One launch, bit-equal to ``random.uniform`` on the same key: a device
  key, the same key from the host, and a row of a device ``split``."""
  key = gtt.random.fold_in(gtt.random.PRNGKey(4), 2 ** 32 - 1)
  dkey = gtt.random.to_device(key, cuda)
  row = gtt.random.split(dkey, 3)[1]
  before = ops.launch_counts()['uniform_draw']
  for k in (dkey, key, row):
    got = ops.draw.uniform(k, shape, device=cuda)
    ref = gtt.random.uniform(k.to(cuda), shape, cuda)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(got, ref)
  n = int(np.prod(shape))
  assert ops.launch_counts()['uniform_draw'] == before + 3 * (n > 0)


def _mode_graph(cuda_or_cpu, weights=True):
  rng = np.random.default_rng(17)
  n = 3000
  ei = np.stack([rng.integers(0, n, 60000), rng.zipf(1.5, 60000) % n])
  ei[0, :900] = 5                    # a hub row above every window
  w = rng.integers(1, 16, ei.shape[1]).astype(np.float32) / 4
  ds = gtt.data.Dataset(device=cuda_or_cpu)
  ds.init_graph(ei, num_nodes=n, edge_weights=w if weights else None)
  return ds, n


_CARD_MODES = {
    'block': (dict(strategy='block'), 2),
    'padded': (dict(padded_window='auto'), 1),
    'weighted': (dict(with_weight=True), 1),
    'budget': (dict(node_budget=500), 0),
}


@pytest.mark.parametrize('dedup', ['tree', 'merge'])
@pytest.mark.parametrize('mode', sorted(_CARD_MODES))
def test_mode_batches_on_card_match_cpu(cuda, mode, dedup):
  """Three batches of each mode on the card equal the CPU's field for
  field; the padded, block and weighted hops draw through the kernel
  (2 launches a block hop, 1 otherwise), the uniform ones through the hop
  or level kernel."""
  kw, draws = _CARD_MODES[mode]
  fanouts = [10, 5, 3]
  outs = {}
  for dev in (cuda, torch.device('cpu')):
    ds, n = _mode_graph(dev)
    s = gtt.sampler.NeighborSampler(ds.graph, fanouts, device=dev, seed=5,
                                    dedup=dedup, **kw)
    if dev.type == 'cuda':
      if s.padded_window is not None:
        s._padded_arrays()        # the table's build draws once
      ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    outs[dev.type] = [s.sample_from_nodes(gtt.sampler.NodeSamplerInput(
        np.concatenate([[5, n - 1], rng.integers(0, n, 60)])), batch_cap=64)
        for _ in range(3)]
    if dev.type == 'cuda':
      counts = ops.launch_counts()
  for a, b in zip(outs['cuda'], outs['cpu']):
    for name in ('node', 'num_nodes', 'row', 'col', 'edge_mask'):
      assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert torch.equal(a.metadata['overflow'].cpu(), b.metadata['overflow'])
  assert counts['uniform_draw'] == 3 * len(fanouts) * draws
  uniform = mode == 'budget'
  if dedup == 'tree':
    assert counts['sample_hop'] == (3 * len(fanouts) if uniform else 0)
    assert counts['sample_level'] == 0
  else:
    assert counts['sample_level'] == (3 * (3 * len(fanouts) + 1) if uniform
                                      else 0)
    assert counts['sample_hop'] == 0


class _SmallPadded(_Small):
  """``_Small`` on the padded-window sampler (tree engine, W = 8)."""

  def loader(self):
    return gtt.loader.NeighborLoader(
        self.ds, self.fanouts, self.pool, batch_size=self.b,
        shuffle=self.shuffle, seed=3, dedup='tree', padded_window=8,
        device=self.cuda)


def test_captured_scan_trainer_samples_the_reseeded_table(cuda):
  """A captured padded-window ScanTrainer over three epochs against an
  eager one from the same weights: the reseed writes into the captured
  table, so every replayed epoch's losses stay within rtol 1e-4 of the
  eager epoch's (a replay on last epoch's table would part at once), and
  each epoch's table differs from the one before."""
  s = _SmallPadded(cuda, 'tree')
  cap, cstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=2)
  eag, estate = s.trainer(gtt.loader.ScanTrainer, chunk_size=2,
                          capture=False)
  tabs = []
  for _ in range(3):
    cstate, closs, _ = cap.run_epoch(cstate)
    estate, eloss, _ = eag.run_epoch(estate)
    torch.testing.assert_close(closs, eloss, rtol=1e-4, atol=0)
    tab = cap._sampler._padded_arrays()['tab']
    assert torch.equal(tab, eag._sampler._padded_arrays()['tab'])
    tabs.append(tab.clone())
  assert cap._graphs and cap._sampler._padded_seed == 5
  assert not torch.equal(tabs[0], tabs[1])
  assert not torch.equal(tabs[1], tabs[2])


def test_padded_captured_crash_resume_replays_the_table(cuda, tmp_path):
  """A captured padded-window ScanTrainer crashed in its second epoch
  (on the reseeded table) and resumed in a fresh captured trainer: the
  resumed epoch's losses within rtol 1e-4 of the uninterrupted epoch's,
  on the same table."""
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  s = _SmallPadded(cuda, 'tree')
  ref, rstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=1)
  victim, vstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=1)
  for tr, st in ((ref, rstate), (victim, vstate)):
    tr.run_epoch(st)
  rstate, rlosses, _ = ref.run_epoch(rstate)
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(victim)

  def killer(c, start, k):
    if c == 2:
      raise RuntimeError('injected crash')

  victim.stage_hook = killer
  with pytest.raises(RuntimeError, match='injected'):
    victim.run_epoch(vstate)
  ck.close()
  assert ck.latest().meta['padded'] == {'seed': 4, 'epochs_started': 2}
  fresh, template = s.trainer(gtt.loader.ScanTrainer, seed=7, chunk_size=1)
  state, losses, _ = ChunkCheckpointer(str(tmp_path)).resume_epoch(
      fresh, template)
  torch.testing.assert_close(torch.as_tensor(losses), rlosses.cpu(),
                             rtol=1e-4, atol=0)
  assert torch.equal(fresh._sampler._padded_arrays()['tab'],
                     ref._sampler._padded_arrays()['tab'])


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_bf16_train_steps_on_card_match_cpu(cuda, mode):
  """Three bf16 train steps (a bf16 feature table and bf16 compute, as
  the example's --bf16-features --bf16-model) on the card against the
  CPU from the same weights: losses within 3e-2 relative (bf16 keeps 8
  significant bits and the two devices sum in other orders; the merge
  backward's bf16 index_add_ adds in no fixed order), parameters and
  Adam's moments float32 on the card."""
  from graphlearn_tpu_torch.models import train
  rng = np.random.default_rng(12)
  n, f, c, fanouts, b = 2000, 32, 7, [5, 4, 3], 64
  ei = np.stack([rng.integers(0, n, 40000), rng.zipf(1.5, 40000) % n])
  feats = rng.standard_normal((n, f)).astype(np.float32)
  labels = rng.integers(0, c, n)
  pool = rng.permutation(n)[:3 * b]
  runs = {}
  for dev in (cuda, torch.device('cpu')):
    ds = gtt.data.Dataset(device=dev)
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feats, dtype=torch.bfloat16)
    ds.init_node_labels(labels)
    loader = gtt.loader.NeighborLoader(ds, fanouts, pool, batch_size=b,
                                       dedup=mode, device=dev)
    if mode == 'merge':
      no, eo = train.merge_hop_offsets(b, fanouts)
    else:
      no, eo = train.tree_hop_offsets(b, fanouts)
    model = gtt.models.GraphSAGE(
        f, 64, c, num_layers=3, hop_node_offsets=no, hop_edge_offsets=eo,
        tree_dense=mode == 'tree', merge_dense=mode == 'merge',
        fanouts=fanouts, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model)
    step, _ = train.make_train_step(model, c)
    losses = []
    for batch in loader:
      assert batch.x.dtype == torch.bfloat16
      state, loss, _ = step(state, train.batch_to_dict(batch))
      losses.append(loss.cpu())
    runs[dev.type] = (torch.stack(losses), model, state)
  torch.testing.assert_close(runs['cuda'][0], runs['cpu'][0], rtol=3e-2,
                             atol=0)
  model, state = runs['cuda'][1], runs['cuda'][2]
  for p in model.parameters():
    assert p.dtype == torch.float32
    assert state.optimizer.state[p]['exp_avg'].dtype == torch.float32


# ------------------------------------------------ the sampling-menu slice


def _neg_csr(cuda, n, e, seed=0, dense_rows=0):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, e)
  cols = rng.zipf(1.5, e) % n
  if dense_rows:
    rows = np.concatenate([rows] + [np.full(n, r) for r in range(dense_rows)])
    cols = np.concatenate([cols] + [np.arange(n)] * dense_rows)
  topo = gtt.data.Topology(np.stack([rows, cols]), num_nodes=n)
  sorted_idx, _ = ops.sort_csr_segments(topo.indptr, topo.indices)
  indptr = torch.as_tensor(topo.indptr.astype(np.int32))
  idx = torch.as_tensor(sorted_idx.astype(np.int32))
  return indptr, idx, indptr.to(cuda), idx.to(cuda)


@pytest.mark.parametrize('n,e,dense,num,trials', [
    (60_000, 200_000, 0, 512, 5), (65_537, 200_000, 0, 512, 5),
    (1_000_003, 3_000_000, 0, 2048, 5), (12, 10, 9, 40, 2),
    (300, 0, 0, 64, 3), (7, 30, 0, 0, 5)])
@pytest.mark.parametrize('padding', [False, True])
def test_negative_sample_kernel_matches_plain(cuda, n, e, dense, num, trials,
                                              padding):
  """The kernel's candidates and the taken negatives equal the plain
  version's on the same device key, across the span 65,536 where randint
  starts to wrap, on a dense graph (a shortfall), an empty one and for no
  samples; one launch a call (none for an empty call); a host key and the
  same key on the device agree."""
  cptr, cidx, gptr, gidx = _neg_csr(cuda, n, e, dense_rows=dense)
  key = gtt.random.fold_in(gtt.random.PRNGKey(3), 11)
  dkey = gtt.random.to_device(key, cuda)
  before = ops.launch_counts()['negative_sample']
  got = ops.random_negative_sample(gptr, gidx, n, n, num, dkey,
                                   trials=trials, padding=padding)
  assert ops.launch_counts()['negative_sample'] == before + (num > 0)
  cand = ops.negative.negative_candidates(gptr, gidx, n, n, num * trials,
                                          dkey)
  plain = ops.negative.negative_candidates_plain(gptr, gidx, n, n,
                                                 num * trials, dkey)
  cpu = ops.negative.negative_candidates_plain(cptr, cidx, n, n,
                                               num * trials, key)
  for a, b, c in zip(cand, plain, cpu):
    assert torch.equal(a, b) and torch.equal(a.cpu(), c)
  want = ops.random_negative_sample_plain(cptr, cidx, n, n, num, key,
                                          trials=trials, padding=padding)
  for a, b in zip(got, want):
    assert torch.equal(a.cpu(), b)
  host = ops.random_negative_sample(gptr, gidx, n, n, num, key,
                                    trials=trials, padding=padding)
  for a, b in zip(got, host):
    assert torch.equal(a, b)


def test_negative_sample_kernel_spans_past_the_rows(cuda):
  """num_src above the CSR's rows (the typed case's key side): row reads
  clamp into indptr as XLA's gather does; num_dst of 1."""
  cptr, cidx, gptr, gidx = _neg_csr(cuda, 100, 800)
  key = gtt.random.PRNGKey(9)
  for src, dst in ((150, 100), (100, 1), (1, 100)):
    got = ops.negative.negative_candidates(gptr, gidx, src, dst, 5000, key)
    want = ops.negative.negative_candidates_plain(cptr, cidx, src, dst,
                                                  5000, key)
    for a, b in zip(got, want):
      assert torch.equal(a.cpu(), b)


def _link_dataset(dev, n=3000, e=40000, feat=8):
  rng = np.random.default_rng(21)
  ei = np.stack([rng.integers(0, n, e), rng.zipf(1.5, e) % n])
  ds = gtt.data.Dataset(device=dev)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(rng.standard_normal((n, feat)).astype(np.float32))
  ds.init_edge_features(rng.standard_normal((e, 2)).astype(np.float32))
  return ds, ei


@pytest.mark.parametrize('dedup', ['auto', 'tree', 'map_table',
                                   'sort_legacy'])
@pytest.mark.parametrize('neg', ['binary', 'triplet'])
def test_link_batches_on_card_match_cpu(cuda, dedup, neg):
  """Three link batches on the card equal the CPU's, field and metadata;
  one negative-sampling launch a batch, each hop through the hop kernel
  (legacy and tree engines) or each level through the level kernel."""
  fanouts = [5, 3]
  outs = {}
  for dev in (cuda, torch.device('cpu')):
    ds, ei = _link_dataset(dev)
    loader = gtt.loader.LinkNeighborLoader(
        ds, fanouts, ei[:, :96], neg_sampling=gtt.sampler.NegativeSampling(
            neg, 1), batch_size=32, shuffle=True, seed=4, dedup=dedup,
        with_edge=True, device=dev)
    ops.reset_launch_counts()
    outs[dev.type] = list(loader)
    if dev.type == 'cuda':
      counts = ops.launch_counts()
  for a, b in zip(outs['cuda'], outs['cpu']):
    for name in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x',
                 'edge_ids', 'edge_attr'):
      assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    for k, v in b.metadata.items():
      if torch.is_tensor(v):
        assert torch.equal(a.metadata[k].cpu(), v), k
  assert counts['negative_sample'] == 3
  assert counts['gather_rows'] == 3
  if dedup == 'auto':
    assert counts['sample_level'] == 3 * (3 * len(fanouts) + 1)
    assert counts['sample_hop'] == 0
  else:
    assert counts['sample_hop'] == 3 * len(fanouts)
    assert counts['sample_level'] == 0


@pytest.mark.parametrize('dedup', ['auto', 'tree'])
def test_link_sampling_makes_no_host_sync(cuda, dedup):
  """The negatives, the seed union on the device and the node sampling of
  a link batch run under ``set_sync_debug_mode('error')``."""
  ds, ei = _link_dataset(cuda)
  s = gtt.sampler.NeighborSampler(ds.graph, [5, 3], device=cuda, seed=2,
                                  dedup=dedup, with_edge=True)
  inp = gtt.sampler.EdgeSamplerInput(
      ei[0][:64], ei[1][:64], neg_sampling=gtt.sampler.NegativeSampling())
  s.sample_from_edges(inp)                     # builds the sorted view
  torch.cuda.synchronize()
  with _no_sync_allowed():
    out = s.sample_from_edges(inp)
  torch.cuda.synchronize()
  assert out.metadata['edge_label_index'].shape == (2, 128)


def test_link_train_step_on_card_matches_cpu(cuda):
  from graphlearn_tpu_torch.models import train
  torch.backends.cuda.matmul.allow_tf32 = False
  batches, models = {}, {}
  for dev in (cuda, torch.device('cpu')):
    ds, ei = _link_dataset(dev)
    loader = gtt.loader.LinkNeighborLoader(
        ds, [5, 3], ei[:, :96], neg_sampling=gtt.sampler.NegativeSampling(),
        batch_size=32, seed=4, device=dev)
    model = gtt.models.GraphSAGE(8, 16, 16, num_layers=2, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model)
    step, _ = train.make_link_train_step(model)
    losses = [step(state, train.link_batch_to_dict(b))[1]
              for b in list(loader)[:2]]
    batches[dev.type], models[dev.type] = losses, model
  for a, b in zip(batches['cuda'], batches['cpu']):
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
  for a, b in zip(models['cuda'].parameters(), models['cpu'].parameters()):
    torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize('bucketed', [False, True])
def test_subgraph_batches_on_card_match_cpu(cuda, bucketed):
  outs = {}
  for dev in (cuda, torch.device('cpu')):
    ds, _ = _link_dataset(dev)
    loader = gtt.loader.SubGraphLoader(
        ds, [4, 2], np.arange(0, 3000, 37), batch_size=16, with_edge=True,
        seed=1, bucketed=bucketed, device=dev)
    ops.reset_launch_counts()
    outs[dev.type] = list(loader)
    if dev.type == 'cuda':
      counts = ops.launch_counts()
  for a, b in zip(outs['cuda'], outs['cpu']):
    for name in ('node', 'num_nodes', 'edge_index', 'edge_mask', 'x',
                 'edge_ids', 'edge_attr', 'batch'):
      assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    for k, v in b.metadata.items():
      if torch.is_tensor(v):
        assert torch.equal(a.metadata[k].cpu(), v), k
  n = len(outs['cuda'])
  assert counts['sample_level'] == n * (3 * 2 + 1)
  assert counts['gather_rows'] == n


# ---------------------------------------------------- the hot/cold gather


def _unified_case(cuda, n, width, dtype, hot, seed=0):
  """(hot rows on the card, mapped cold rows, the whole table on the CPU)."""
  from graphlearn_tpu_torch.ops import mapped
  gen = torch.Generator().manual_seed(seed)
  table = (torch.randn((n, width), generator=gen) * 100).to(dtype)
  cold = mapped.empty((n - hot, width), dtype)
  cold.copy_(table[hot:])
  if n - hot:
    mapped.register(cold, cuda)
  return table[:hot].contiguous().to(cuda), cold, table


_ID_PATTERNS = ['random', 'one_row', 'repeat50', 'distinct']


def _unified_ids(pattern, n, hot_rows, gen):
  """Lookup ids over a table of ``n`` rows, ``hot_rows`` on the card:
  random ids past both ends (clamped), every slot one cold row, every
  cold row (every row with no cold part) 50 times in shuffled order, or
  a permutation of the table's rows (no duplicate)."""
  if pattern == 'random':
    return torch.randint(-5, n + 5, (4099,), generator=gen)
  if pattern == 'one_row':
    return torch.full((4099,), n - 1, dtype=torch.int64)
  if pattern == 'repeat50':
    rows = torch.arange(hot_rows if hot_rows < n else 0, n).repeat(50)
    return rows[torch.randperm(rows.numel(), generator=gen)]
  return torch.randperm(n, generator=gen)


def _distinct_cold(ids, n, hot_rows):
  return int((torch.unique(ids.cpu().clamp(0, n - 1)) >= hot_rows).sum())


@pytest.mark.parametrize('dtype,width', [
    (torch.float32, 100), (torch.float32, 128), (torch.bfloat16, 100),
    (torch.float16, 3), (torch.int32, 7), (torch.bfloat16, 1)])
@pytest.mark.parametrize('split', ['all_host', 'mixed', 'all_hot'])
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('pattern', _ID_PATTERNS)
def test_gather_unified_kernel_matches_plain(cuda, dtype, width, split,
                                             id_dtype, pattern):
  """The hot/cold kernel against its plain version (the JAX store's
  mixed gather on the card), bit for bit: H = 0, a mixed split and H = N,
  row widths down to 2 bytes, ids clamped at both ends, one cold row in
  every slot, every cold row 50 times, no duplicate. Its fetch counter
  equals the distinct cold rows; the call makes no host sync, counts one
  launch, and none for no ids."""
  from graphlearn_tpu_torch.ops import mapped
  n = 1000
  hot_rows = dict(all_host=0, mixed=371, all_hot=n)[split]
  hot, cold, table = _unified_case(cuda, n, width, dtype, hot_rows, width)
  gen = torch.Generator().manual_seed(3)
  ids = _unified_ids(pattern, n, hot_rows, gen).to(id_dtype).to(cuda)
  before = ops.launch_counts()['gather_unified']
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = ops.gather_rows_unified(hot, cold, ids)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  torch.cuda.synchronize()
  plain, _ = ops.gather_rows_unified_plain(hot, cold, ids)
  assert torch.equal(got, plain)
  assert torch.equal(got.cpu(), table[ids.cpu().clamp(0, n - 1).long()])
  assert ops.launch_counts()['gather_unified'] == before + 1
  assert int(ops.gather.unified_fetches) == _distinct_cold(ids, n, hot_rows)
  assert ops.gather_rows_unified(hot, cold, ids[:0]).shape == (0, width)
  assert ops.launch_counts()['gather_unified'] == before + 1
  if n - hot_rows:
    mapped.release(cold)
    assert not mapped.is_mapped(cold)


def test_gather_unified_refuses_unmapped_rows(cuda):
  hot = torch.zeros((4, 8), device=cuda)
  cold = torch.zeros((4, 8))
  with pytest.raises(ValueError, match='not mapped'):
    ops.gather_rows_unified(hot, cold, torch.zeros(2, dtype=torch.int32,
                                                   device=cuda))


def test_mapped_tail_freed_and_registered_again(cuda):
  """A store's mapped tail is released (after its last launch) when the
  store goes, and a new store maps a tail again; the same tensor mapped
  twice counts a reference."""
  from graphlearn_tpu_torch.ops import mapped
  feat = np.random.default_rng(0).standard_normal((5000, 64)).astype(
      np.float32)
  ids = torch.randint(0, 5000, (20000,), device=cuda)
  for _ in range(3):
    ut = gtt.data.UnifiedTensor(cuda).init_from(feat[:1000], feat[1000:])
    tail = ut.host_part
    assert mapped.is_mapped(tail) and mapped.lookup(tail).nbytes == \
        4000 * 64 * 4
    got = ut[ids]              # queued; the release below waits for it
    del ut
    gc.collect()
    assert not mapped.is_mapped(tail)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.from_numpy(feat)[ids.cpu()])
  cold = mapped.empty((10, 4), torch.float32)
  mapped.register(cold, cuda)
  mapped.register(cold, cuda)
  mapped.release(cold)
  assert mapped.is_mapped(cold)
  mapped.release(cold)
  assert not mapped.is_mapped(cold)
  view = mapped.empty((10, 4), torch.float32)
  mapped.register(view, cuda)
  with pytest.raises(ValueError, match='overlaps'):
    mapped.register(view[2:], cuda)
  assert mapped.device_pointer(view[2:]) == \
      mapped.device_pointer(view) + 2 * 4 * 4
  mapped.release(view)


@pytest.mark.parametrize('split_ratio', [0.0, 0.3, 1.0])
def test_feature_on_card_matches_cpu_without_host_sync(cuda, split_ratio):
  """A hot/cold ``Feature`` on the card (FILL pads, ids past the table,
  a degree reorder, bf16) equals the CPU store's rows, with no host sync
  in the lookup; ``device_table()`` is None with a host part."""
  rng = np.random.default_rng(1)
  n = 3000
  feat = rng.standard_normal((n, 100)).astype(np.float32)
  ei = np.stack([rng.integers(0, n, 9000), rng.zipf(1.5, 9000) % n])
  re, id2index = gtt.data.sort_by_in_degree(
      feat, split_ratio, gtt.data.Topology(ei, num_nodes=n))
  ids = rng.integers(0, n, 5000)
  ids[::11] = -1
  ids[3::97] = n + 4
  for dtype in (None, torch.bfloat16):
    stores = {d: gtt.data.Feature(re, split_ratio, id2index=id2index,
                                  device=d, dtype=dtype)
              for d in (cuda, torch.device('cpu'))}
    card = stores[cuda]
    card.lazy_init()
    assert (card.device_table() is None) == (split_ratio < 1.0)
    ids_dev = torch.as_tensor(ids, device=cuda)
    card[ids_dev]
    torch.cuda.synchronize()
    with _no_sync_allowed():
      got = card[ids_dev]
    torch.cuda.synchronize()
    want = stores[torch.device('cpu')][ids]
    assert torch.equal(got.cpu().isnan(), want.isnan())
    assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())


def test_feature_ipc_in_process_on_card(cuda):
  feat = np.random.default_rng(2).standard_normal((400, 16)).astype(
      np.float32)
  store = gtt.data.Feature(feat, split_ratio=0.25, device=cuda)
  clone = gtt.data.Feature.from_ipc_handle(store.share_ipc())
  ids = torch.arange(400, device=cuda)
  assert torch.equal(clone[ids], store[ids])
  assert torch.equal(clone[ids].cpu(), torch.from_numpy(feat))
  assert store.unified.host_part.is_shared()
  del clone
  gc.collect()
  assert torch.equal(store[ids].cpu(), torch.from_numpy(feat))


def test_feature_mp_two_workers_on_card(cuda):
  """The spawned ``feature_mp`` run: the device prefix as a CUDA IPC
  handle, the host tail in shared memory mapped again in each worker;
  every worker's rows exact."""
  from graphlearn_tpu_torch.examples import feature_mp
  assert feature_mp.run(cuda, timeout=300) == [(0, 'ok'), (1, 'ok')]


def test_feature_mp_ends_with_every_ipc_handle_released(cuda):
  """The spawned ``feature_mp`` example in a child interpreter: its
  workers drop the store's CUDA IPC handle before they exit (the Process
  object keeps its arguments until then), so torch never reports that
  the producer ended before its shared CUDA tensors were released."""
  import os
  import subprocess
  import sys
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run(
      [sys.executable, '-m', 'graphlearn_tpu_torch.examples.feature_mp'],
      capture_output=True, text=True, timeout=300,
      env=dict(os.environ, PYTHONPATH=root))
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert 'feature_mp OK' in proc.stdout
  assert 'shared CUDA tensors released' not in proc.stderr, \
      proc.stderr[-3000:]


@pytest.mark.parametrize('dedup', ['tree', 'auto'])
def test_hot_cold_loader_on_card_matches_cpu(cuda, dedup):
  """NeighborLoader batches over a hot/cold store: the same batches as
  the CPU's, one hot/cold launch and no row-gather launch a batch."""
  rng = np.random.default_rng(3)
  n = 2000
  ei = np.stack([rng.integers(0, n, 12000), rng.integers(0, n, 12000)])
  feat = rng.standard_normal((n, 24)).astype(np.float32)
  labels = rng.integers(0, 3, n)
  outs = {}
  for dev in (cuda, torch.device('cpu')):
    ds = gtt.data.Dataset(device=dev)
    ds.init_graph(ei, num_nodes=n)
    ds.init_node_features(feat, sort_func=gtt.data.sort_by_in_degree,
                          split_ratio=0.4)
    ds.init_node_labels(labels)
    loader = gtt.loader.NeighborLoader(ds, [5, 3], np.arange(0, n, 7),
                                       batch_size=64, seed=2, dedup=dedup,
                                       device=dev)
    ops.reset_launch_counts()
    outs[dev.type] = list(loader)
    if dev.type == 'cuda':
      counts = ops.launch_counts()
  for a, b in zip(outs['cuda'], outs['cpu']):
    for name in ('node', 'x', 'y', 'edge_index'):
      assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
  assert counts['gather_unified'] == len(outs['cuda'])
  assert counts['gather_rows'] == 0


# ------------------------------------------------------- the tiered store


def _tiered_ds(s, spill_dir, hot=500, warm=500):
  """``_Small``'s dataset with its features in a TieredFeature: ``hot``
  rows on the card, ``warm`` mapped on the host, the rest on disk."""
  feat = s.ds.node_features.feature_array
  return gtt.data.Dataset(
      graph=s.ds.graph, node_labels=s.ds.node_labels, device=s.cuda,
      node_features=gtt.storage.TieredFeature(
          feat, hot_rows=hot, warm_rows=warm, spill_dir=str(spill_dir),
          device=s.cuda))


class _SmallTiered(_Small):
  """``_Small`` whose loaders read a TieredFeature (500 hot, 500 warm and
  1,000 disk rows of 2,000)."""

  def __init__(self, cuda, mode, spill_dir, shuffle=True):
    super().__init__(cuda, mode, shuffle)
    self.all_device = self.ds
    self.ds = _tiered_ds(self, spill_dir)


def _last_chunk_x(tr, steps, epoch):
  """Each step's ``x`` of the epoch's last chunk (k = 1), rebuilt with
  the trainer's own body (the tiered one reads the slab the chunk left
  in its static buffers)."""
  seeds, mask = tr._epoch_seeds(gtt.random.fold_in(tr._perm_key, epoch),
                                steps)
  count0 = tr._sampler._call_count - steps + 1
  keys = gtt.random.step_keys_plain(
      tr._sampler._key, count0 + torch.arange(steps, dtype=torch.int64),
      len(tr._sampler.num_neighbors)).to(tr.loader.device)
  batch, _ = tr._sample_collate(seeds[-1], mask[-1], keys[-1])
  return batch['x']


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_tiered_captured_epoch_matches_eager_and_all_device(cuda, mode,
                                                            tmp_path):
  """A captured TieredScanTrainer (chunks of 1, a ring of two slots, so
  every slot is refilled after its ack) against the eager tiered one and
  the captured all-device ScanTrainer from one start, over two epochs:
  the plans exact between captured and eager, the last chunk's ``x``
  bit-equal to the all-device gather, losses exact (tree) or within
  rtol 1e-4 (merge: the backward's atomics), one step-keys launch a
  chunk plus the plan's, no degraded staging."""
  s = _SmallTiered(cuda, mode, tmp_path / 'sp')
  cap, cstate = s.trainer(gtt.storage.TieredScanTrainer, chunk_size=1,
                          max_ahead=1)
  eag, estate = s.trainer(gtt.storage.TieredScanTrainer, chunk_size=1,
                          max_ahead=1, capture=False)
  tiered_ds, s.ds = s.ds, s.all_device
  ref, rstate = s.trainer(gtt.loader.ScanTrainer, chunk_size=1)
  s.ds = tiered_ds
  assert cap.capture and not eag.capture and ref.capture
  for epoch in range(2):
    ops.reset_launch_counts()
    cstate, closs, _ = cap.run_epoch(cstate)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    estate, eloss, _ = eag.run_epoch(estate)
    rstate, rloss, _ = ref.run_epoch(rstate)
    torch.cuda.synchronize()
    for a, b in zip(cap.last_plan.chunk_rows, eag.last_plan.chunk_rows):
      np.testing.assert_array_equal(a, b)
    assert cap.last_plan.num_chunks == 4
    assert counts['step_keys'] == 4 + 1      # the chunks' and the plan's
    assert not cap._stager.degraded and not eag._stager.degraded
    assert cap._stager.refills and all(d for _, d in cap._stager.refills)
    if mode == 'tree':
      assert torch.equal(closs, rloss)
    torch.testing.assert_close(closs, rloss, rtol=1e-4, atol=0)
    torch.testing.assert_close(closs, eloss, rtol=1e-4, atol=0)
    assert torch.equal(_last_chunk_x(cap, 4, epoch),
                       _last_chunk_x(ref, 4, epoch))
  assert sorted(cap._graphs) == [1] and cap.slab_bytes > 0
  timings = cap.chunk_timings()
  assert len(timings) == 4 and all(t['device_ms'] > 0 for t in timings)
  _close_params(cap.model, ref.model)
  for tr in (cap, eag):
    tr.close()


def test_tiered_epoch_syncs_once_for_its_plan(cuda, tmp_path):
  """A replayed tiered epoch makes one host sync, the plan fetch: under
  ``set_sync_debug_mode('warn')`` it is the only one counted, and with
  the fetch let through the whole epoch runs under 'error'."""
  import warnings
  s = _SmallTiered(cuda, 'tree', tmp_path / 'sp')
  tr, state = s.trainer(gtt.storage.TieredScanTrainer, chunk_size=2)
  state, _, _ = tr.run_epoch(state)        # warm-up and captures
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      state, _, _ = tr.run_epoch(state)
    finally:
      torch.cuda.set_sync_debug_mode('default')
  syncs = [w for w in caught if 'synchroniz' in str(w.message).lower()
           and 'prototype' not in str(w.message)]
  assert len(syncs) == 1, [str(w.message) for w in syncs]
  fetch = tr._fetch_plan_rows

  def fetch_allowed(rows):
    torch.cuda.set_sync_debug_mode('default')
    try:
      return fetch(rows)
    finally:
      torch.cuda.set_sync_debug_mode('error')

  tr._fetch_plan_rows = fetch_allowed
  torch.cuda.synchronize()
  with _no_sync_allowed():
    state, losses, _ = tr.run_epoch(state)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(losses).all()) and state.step == 12
  tr.close()


def test_staging_slot_waits_for_its_copy_event(cuda, tmp_path):
  """H7a on the card: a slab copied to the device behind a long kernel
  and acked with the copy's event; the chunk that shares its slot is not
  staged until the event has completed, and the device copy holds the
  first slab's bytes, not the refill's."""
  feat = np.random.default_rng(5).standard_normal((64, 4)).astype(
      np.float32)
  tf = gtt.storage.TieredFeature(feat, hot_rows=8, warm_rows=8,
                                 spill_dir=str(tmp_path / 'sp'), device=cuda)
  plan = [np.arange(16, 24), np.arange(24, 32), np.arange(40, 48)]
  stager = gtt.storage.ChunkStager(tf, max_ahead=1, timeout_s=30.0)
  stager.begin_epoch(plan)
  ids0, rows0 = stager.take(0)
  assert rows0.is_pinned() and ids0.is_pinned()
  dst = torch.empty(rows0.shape, device=cuda)
  torch.cuda._sleep(2_000_000_000)           # ~1 s of spin ahead of it
  dst.copy_(rows0, non_blocking=True)
  ev = torch.cuda.Event()
  ev.record()
  stager.ack(0, ev)
  stager.take(1)                             # submits chunk 2 (slot 0)
  time.sleep(0.2)
  assert not ev.query() and 2 not in stager.stage_done_t
  ids2, rows2 = stager.take(2)               # staged once the event is done
  assert ev.query() and not stager.degraded
  assert ids2.data_ptr() == ids0.data_ptr()
  torch.cuda.synchronize()
  assert torch.equal(dst.cpu(), torch.from_numpy(feat[16:24]))
  assert torch.equal(rows2, torch.from_numpy(feat[40:48]))
  stager.close()


def test_tiered_feature_on_card_matches_cpu(cuda, tmp_path):
  """The reactive lookup on the card (FILL pads, a degree reorder, ids
  past the table): equal to the CPU store's rows; device ids cost one
  host sync with a disk tier, host ids none, one hot/cold launch a
  lookup; the warm block's mapping is released after its last launch."""
  import warnings
  from graphlearn_tpu_torch.ops import mapped
  rng = np.random.default_rng(4)
  n = 3000
  feat = rng.standard_normal((n, 100)).astype(np.float32)
  ei = np.stack([rng.integers(0, n, 9000), rng.zipf(1.5, 9000) % n])
  re, id2index = gtt.data.sort_by_in_degree(
      feat, 0.2, gtt.data.Topology(ei, num_nodes=n))
  ids = rng.integers(0, n, 5000)
  ids[::11] = -1
  ids[3::97] = n + 4
  for hot, warm in ((600, 900), (0, 900), (600, 0), (0, 0), (n, 0)):
    stores = {d: gtt.storage.TieredFeature(
        re, hot_rows=hot, warm_rows=warm, id2index=id2index,
        spill_dir=str(tmp_path / f'{d}{hot}_{warm}'), device=d)
              for d in ('cuda', 'cpu')}
    card = stores['cuda']
    card.lazy_init()                         # placing the tiers syncs
    want = stores['cpu'][ids]
    ids_dev = torch.as_tensor(ids, device=cuda)
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      torch.cuda.set_sync_debug_mode('warn')
      try:
        got = card[ids_dev]
      finally:
        torch.cuda.set_sync_debug_mode('default')
    syncs = [w for w in caught if 'synchroniz' in str(w.message).lower()
             and 'prototype' not in str(w.message)]
    assert len(syncs) == int(card.disk_rows > 0)
    assert card.host_syncs == int(card.disk_rows > 0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().isnan(), want.isnan())
    assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())
    valid = ids[(ids >= 0) & (ids < n)]
    with _no_sync_allowed():
      got = card[valid]                      # host ids: no sync
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.from_numpy(feat[valid]))
    assert ops.launch_counts()['gather_unified'] == \
        (2 if hot + warm else 0)
  store = gtt.storage.TieredFeature(re, hot_rows=600, warm_rows=900,
                                    spill_dir=str(tmp_path / 'rel'),
                                    device=cuda)
  store.lazy_init()
  warm_t = store.unified.host_part
  assert mapped.is_mapped(warm_t)
  got = store[np.arange(n)]                  # queued; release waits for it
  del store
  gc.collect()
  assert not mapped.is_mapped(warm_t)
  torch.cuda.synchronize()
  assert torch.equal(got.cpu(), torch.from_numpy(re))


# ------------------------------------------------------------------ typed


def _chip_smoke():
  """chip_smoke.py's typed-phase helpers, loaded from the checkout root."""
  import importlib.util
  import pathlib
  path = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'
  spec = importlib.util.spec_from_file_location('chip_smoke_typed', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _typed_setup(b=64):
  """A small IGBH-shaped graph (the example's generator) on the card and
  the CPU, its seed pool and calibrated caps."""
  from graphlearn_tpu_torch.examples import train_rgnn as ex
  cs = _chip_smoke()
  dataset, wgraphs = cs.hetero_data(torch, gtt, ex, 3000, 1500)
  ds = dataset(torch.device('cuda'))
  pool = np.arange(600)
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      ds.graph, ex.FANOUTS, {'paper': b}, input_nodes={'paper': pool})
  return cs, ex, dataset, wgraphs, ds, pool, caps


@pytest.mark.parametrize('kind', ['tree', 'merge'])
def test_typed_batches_on_card_match_cpu(cuda, kind):
  """Typed tree and calibrated merge batches of the example's loader on
  the card: the hop kernel once per plan item and the row gather once
  per featured type (counters and profiler), the last batch equal to the
  CPU's from the same sampler state, no batch truncated; block and
  weighted typed batches equal to the CPU's, the draw kernel 2 / 1 times
  an item."""
  cs, ex, dataset, wgraphs, ds, pool, caps = _typed_setup()
  rec, batches = cs.hetero_batches(torch, gtt, ex, ds,
                                   dataset(torch.device('cpu')), pool, cuda,
                                   kind, caps, 64, 3, 'test')
  assert rec['items'] == 5 and len(batches) == 3
  assert rec['launches']['sample_hop'] == 15
  assert rec['launches']['gather_rows'] == 6
  if kind == 'merge':
    menu = cs.hetero_menu_batches(torch, gtt, ex, wgraphs, pool, cuda, 64,
                                  'test')
    assert menu['block']['launches']['uniform_draw'] == 10
    assert menu['weighted']['launches']['uniform_draw'] == 5


@pytest.mark.parametrize('kind', ['tree', 'merge'])
def test_typed_sampling_and_collate_make_no_host_sync(cuda, kind):
  """A typed batch (unclamped tree or merge) is sampled and collated
  without a host sync: seeds and keys go up from pinned memory, the hops
  and the gathers only queue work."""
  cs, ex, dataset, _, ds, pool, _ = _typed_setup()
  loader = gtt.loader.NeighborLoader(ds, ex.FANOUTS, ('paper', pool),
                                     batch_size=64, dedup=kind,
                                     device=cuda)
  it = iter(loader)
  next(it)                                 # first use: the tables
  inp = gtt.sampler.NodeSamplerInput(pool[:64], 'paper')
  with _no_sync_allowed():
    out = loader.sampler.sample_from_nodes(inp, batch_cap=64)
    batch = loader._collate_fn(out)
  torch.cuda.synchronize()
  assert set(batch.x) == {'paper', 'author'}
  assert bool(torch.isfinite(batch.x['paper']).all())


def test_typed_rgat_tree_dense_train_step_on_card_matches_cpu(cuda):
  """Three rgat (4 heads) tree-dense train steps of the example's loop on
  the card, the last recomputed on the CPU from the card's state before
  it within the cpu_step_check tolerances; launches per step as planned,
  0 host syncs a step, the profiler's kernels equal to the counters."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cs, ex, _, _, ds, pool, caps = _typed_setup()
  rep = cs.hetero_train(torch, gtt, ex, ds, pool, cuda, 'tree', 'rgat',
                        caps, 64, 3, 'test')
  assert rep['launches']['sample_hop'] == 15
  assert rep['launches']['gather_rows'] == 6
  assert rep['host_syncs_per_step'] == 0
  assert not rep['cpu_check']['grad_fail']


# ------------------------------------------------------------------ models


def _mag_setup(b=32):
  """The HGT example's MAG-shaped graph at 3,000 papers on the card and
  the CPU, its seed pool and calibrated caps (chip_smoke.py's helpers)."""
  cs = _chip_smoke()
  ex, dataset = cs.mag_example(gtt, 3000, 2)
  ds = dataset(torch.device('cuda'))
  pool = np.arange(600)
  caps = gtt.sampler.estimate_hetero_frontier_caps(
      ds.graph, ex.FANOUTS, {'paper': b}, input_nodes={'paper': pool})
  return cs, ex, dataset, ds, pool, caps


def test_hgt_forwards_on_card_match_cpu(cuda):
  """HGT (hidden 16, 2 heads) in its segment, hierarchical, tree-dense and
  merge-dense forwards on typed batches of the example's loader: logits
  within rtol 1e-3, atol 1e-4 of the CPU's, the forwards' seed logits in
  agreement; the batches bit-equal to the CPU's, K3 once per plan item
  and K1 once per featured type."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cs, ex, dataset, ds, pool, caps = _mag_setup()
  cpu_ds = dataset(torch.device('cpu'))
  batches = {}
  for kind in ('tree', 'merge'):
    rec, batches[kind] = cs.hetero_batches(torch, gtt, ex, ds, cpu_ds, pool,
                                           cuda, kind, caps, 32, 2, 'test')
    assert rec['launches']['gather_rows'] == 2 * 4
  rep = cs.hgt_inference(torch, gtt, ex, batches, caps, cuda, 32, 16, 'test')
  assert set(rep) == {'tree/segment', 'tree/hierarchical', 'tree/tree_dense',
                      'merge/segment', 'merge/merge_dense'}


@pytest.mark.parametrize('kind', ['tree', 'merge'])
def test_hgt_typed_step_makes_no_host_sync(cuda, kind):
  """Three HGT train steps of the example's loop on the card (tree-dense
  and merge-dense): 0 host syncs a step, the last step recomputed on the
  CPU within the cpu_step_check tolerances, the profiler's kernels equal
  to the counters."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cs, ex, _, ds, pool, caps = _mag_setup()
  rep = cs.hetero_train(torch, gtt, ex, ds, pool, cuda, kind, 'hgt', caps,
                        32, 3, 'test', hidden=16)
  assert rep['host_syncs_per_step'] == 0
  assert rep['launches']['gather_rows'] == 3 * 4


def test_gat_forwards_on_card_match_cpu(cuda):
  """The tree-dense and merge-dense GAT (3 layers of 2 heads) on tree and
  calibrated merge batches of a 20,000-node graph at batch 64: against
  the segment forward and the CPU (rtol 1e-3, atol 1e-4); K3 3 and K1 1 a
  tree batch, K4 10 a merge batch."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cs = _chip_smoke()
  cs.BATCH = 64
  ei, feats, labels = cs.make_graph(20000, 25)
  topo = gtt.data.Topology(ei, num_nodes=20000)
  ds = gtt.data.Dataset(device=cuda)
  ds.graph = gtt.data.Graph(topo, device=cuda)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  pool = np.random.default_rng(1).permutation(20000)[:64 * 4]
  caps = list(cs.make_loader(gtt, ds, pool, cuda,
                             'merge').sampler.frontier_caps)
  rep = cs.gat_forwards(torch, gtt, ds, pool, cuda, caps, 'test')
  assert rep['tree']['launches']['sample_hop'] == 6
  assert rep['merge']['launches']['sample_level'] == 20


# ------------------------------------------ typed link, typed serving, prob


@pytest.mark.parametrize('neg,dedup', [('binary', 'tree'), ('triplet', 'tree'),
                                       ('binary', 'merge')])
def test_typed_link_batch_on_card_matches_cpu_without_host_sync(cuda, neg,
                                                                dedup):
  """A typed link batch of writes edges (author -> paper) on the card:
  sampled and collated under ``set_sync_debug_mode('error')``, equal to
  the CPU's from the same sampler state (nodes, edges, features,
  metadata), with the negative kernel once, K3 once per plan item and K1
  once per featured type."""
  from graphlearn_tpu_torch.sampler import EdgeSamplerInput, NegativeSampling
  cs, ex, dataset, _, ds, _, _ = _typed_setup()
  cpu_ds = dataset(torch.device('cpu'))
  topo = ds.graph[ex.WRITES].topo
  src = np.repeat(np.arange(topo.indptr.shape[0] - 1), np.diff(topo.indptr))
  pick = np.random.default_rng(0).choice(topo.num_edges, 64, replace=False)
  rows, cols = src[pick], topo.indices[pick]
  ns = NegativeSampling(neg, 1 if neg == 'binary' else 2)
  kw = dict(dedup=dedup)
  if dedup == 'merge':
    kw['frontier_caps'] = gtt.sampler.estimate_hetero_frontier_caps(
        ds.graph, ex.FANOUTS, {'author': 128, 'paper': 128}, slack=2.0)
  loaders = [gtt.loader.LinkNeighborLoader(
      d, ex.FANOUTS, (ex.WRITES, np.stack([rows, cols])), neg_sampling=ns,
      batch_size=64, seed=3, device=d.device, **kw) for d in (ds, cpu_ds)]
  card, host = (ld.sampler for ld in loaders)
  inp = EdgeSamplerInput(rows, cols, None, ex.WRITES, ns)
  loaders[0]._collate_fn(card.sample_from_edges(inp))   # first use
  host.load_state_dict(card.state_dict())
  ops.reset_launch_counts()
  with _no_sync_allowed():
    out = loaders[0]._collate_fn(card.sample_from_edges(inp))
  torch.cuda.synchronize()
  counts = ops.launch_counts()
  want = loaders[1]._collate_fn(host.sample_from_edges(inp))
  cs.assert_hetero_equal(torch, out, want, 'typed link batch')
  got_md, want_md = cs.link_md(torch, out), cs.link_md(torch, want)
  assert sorted(got_md) == sorted(want_md)
  for k in want_md:
    assert torch.equal(got_md[k], want_md[k]), k
  assert counts['negative_sample'] == 1
  assert counts['gather_rows'] == 2
  assert counts['sample_hop'] >= 5 and counts['sample_level'] == 0


@pytest.mark.parametrize('conv', ['rsage', 'rgat'])
def test_hetero_materializer_on_card_matches_cpu(cuda, conv):
  """The typed materializer on the card against the CPU's from the same
  weights: every pass's rows (chip_smoke's recheck at 512 ids a type)
  and the final table within rtol 1e-3 / atol 1e-4, two row gathers a
  conv block, and the typed refresh of 64 papers equal to the table."""
  torch.backends.cuda.matmul.allow_tf32 = False
  cs, ex, dataset, _, ds, _, _ = _typed_setup()
  cpu = torch.device('cpu')
  cpu_ds = dataset(cpu)
  model = ex.build_model(conv, 1, 32, cuda, mode='segment',
                         generator=torch.Generator().manual_seed(0)).eval()
  cmodel = ex.build_model(conv, 1, 32, cpu, mode='segment').eval()
  cmodel.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
  mat = gtt.serving.EmbeddingMaterializer(ds, model, block_size=256)
  cmat = gtt.serving.EmbeddingMaterializer(cpu_ds, cmodel, block_size=256)
  table, passes = cs.hetero_materialize_recorded(torch, mat)
  want = cmat.materialize()
  torch.testing.assert_close(table.cpu(), want, rtol=1e-3, atol=1e-4)
  cs.TSERVE_CHECK = 512
  diffs = cs.hetero_recheck(torch, gtt, mat, cmat, passes,
                            np.random.default_rng(1))
  assert len(diffs) == 7
  for p in passes:
    if p['label'][0].isdigit():
      assert p['gather_rows'] == 2 * p['blocks'], p['label']
  ids = np.arange(0, 3000, 47)
  torch.testing.assert_close(
      torch.as_tensor(mat.refresh_rows(ids, ntype='paper')),
      table[torch.as_tensor(ids).to(cuda)].cpu(), rtol=1e-3, atol=1e-4)


def test_sample_prob_on_card_matches_cpu(cuda):
  """``sample_prob`` on the card over a 20,000-node graph at [15, 10, 5]:
  within rtol 1e-5 / atol 1e-6 of the CPU's (float32 atomics add in no
  fixed order)."""
  cs = _chip_smoke()
  ei, _, _ = cs.make_graph(20000, 25)
  topo = gtt.data.Topology(ei, num_nodes=20000)
  seeds = np.random.default_rng(2).choice(20000, 256, replace=False)
  got = gtt.sampler.NeighborSampler(
      gtt.data.Graph(topo, device=cuda), [15, 10, 5],
      device=cuda).sample_prob(seeds)
  want = gtt.sampler.NeighborSampler(
      gtt.data.Graph(topo, device='cpu'), [15, 10, 5],
      device='cpu').sample_prob(seeds)
  assert got.device.type == 'cuda'
  torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dedup,frac', [('tree', None), ('sort', 2.0)])
def test_dist_batches_on_card_match_cpu(cuda, dedup, frac):
  """The distributed loader over P = 4 shards of a 20,000-node graph on
  one card (chip_smoke.py's dist-phase helpers at a small size): every
  shard's batch equal to the CPU sampler's on the same seeds and keys,
  ``x`` and ``y`` the rows and labels of its ids; K3 P x hops and K1 3P a
  batch; the host syncs exactly the counted verdict reads (none at
  ``bucket_frac=None``)."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  cs = _chip_smoke()
  n, p, b = 20000, 4, 128
  ei, feats, labels = cs.make_graph(n, 25)
  pb = cs.dist_book(n, p)
  parts, fparts = ex.partition_in_memory(ei, feats, pb, p)
  dg = gdist.DistGraph(p, 0, parts, pb)
  mesh = gdist.ShardMesh(p, cuda)
  ds = gdist.DistDataset(p, 0, dg, gdist.DistFeature(
      p, fparts, pb, mesh, split_ratio=0.1,
      hotness=np.bincount(ei[1], minlength=n), bucket_frac=frac),
      node_labels=labels)
  pool = np.random.default_rng(1).permutation(n)[:p * b * 3]
  loader = gdist.DistNeighborLoader(ds, cs.FANOUTS, pool, batch_size=b,
                                    seed=0, mesh=mesh, dedup=dedup,
                                    bucket_frac=frac)
  host = gdist.DistNeighborSampler(dg, cs.FANOUTS,
                                   gdist.ShardMesh(p, 'cpu'), seed=0,
                                   dedup=dedup, bucket_frac=frac)
  blocks = list(loader._index_blocks())
  it = iter(loader)
  next(it)
  torch.cuda.synchronize()
  ops.reset_launch_counts()
  gdist.reset_verdict_syncs()
  batch, syncs, kinds = cs.count_syncs(torch, lambda: next(it))
  counts = ops.launch_counts()
  assert counts['sample_hop'] == p * len(cs.FANOUTS)
  assert counts['gather_rows'] == 3 * p
  expect = cs.dist_expected_syncs(gtt, loader.sampler, ds.node_features, b,
                                  frac)
  assert syncs == gdist.verdict_syncs() == expect, kinds
  if frac is None:
    assert syncs == 0
  cs.dist_batch_check(torch, host,
                      NodeSamplerInput(loader.input_seeds[blocks[1][0]]),
                      loader.sampler._keys_for(2), batch,
                      torch.as_tensor(feats).to(cuda),
                      torch.as_tensor(labels).to(cuda))


@pytest.mark.parametrize('n_steps,n_parts,count', [(1, 4, 0), (4, 4, 7),
                                                   (3, 2, 2 ** 32 - 2),
                                                   (16, 8, 2 ** 31 - 5)])
def test_dist_step_keys_kernel_matches_plain(cuda, n_steps, n_parts, count):
  """The distributed chunk's keys from a device counter: exact against
  ``random.dist_step_keys_plain`` on the same device words (counts past
  2**31 and 2**32 wrap); one launch, no host sync."""
  base = gtt.random.fold_in(gtt.random.PRNGKey(5), 1)
  dbase = gtt.random.to_device(base, cuda)
  counter = torch.full((), count, dtype=torch.int64, device=cuda)
  before = ops.launch_counts()['dist_step_keys']
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = ops.dist_step_keys(dbase, counter, n_steps, n_parts, 3)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  torch.cuda.synchronize()
  assert ops.launch_counts()['dist_step_keys'] == before + 1
  want = gtt.random.dist_step_keys_plain(
      base, count + torch.arange(n_steps, dtype=torch.int64), n_parts, 3)
  assert got.shape == (n_steps, n_parts, 3, 2)
  assert torch.equal(got.cpu(), want)


def _dist_scan_pair(cuda, frac=None):
  """Two DistScanTrainers from one start over P = 4 shards of a 4,000-node
  graph on the card, captured and eager: 5 steps of 4 x 32 seeds (the
  last ragged) in chunks of 2, tree batches."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  torch.backends.cuda.matmul.allow_tf32 = False
  cs = _chip_smoke()
  n, p, b = 4000, 4, 32
  ei, feats, labels = cs.make_graph(n, 10)
  pb = cs.dist_book(n, p)
  parts, fparts = ex.partition_in_memory(ei, feats, pb, p)
  pool = np.random.default_rng(2).permutation(n)[:4 * p * b + 40]
  out = []
  for capture in (True, False):
    mesh = gdist.ShardMesh(p, cuda)
    ds = gdist.DistDataset(p, 0, gdist.DistGraph(p, 0, parts, pb),
                           gdist.DistFeature(p, fparts, pb, mesh,
                                             split_ratio=0.1,
                                             bucket_frac=frac),
                           node_labels=labels)
    loader = gdist.DistNeighborLoader(ds, [5, 3], pool, batch_size=b,
                                      shuffle=True, drop_last=False, seed=0,
                                      mesh=mesh, dedup='tree',
                                      bucket_frac=frac)
    model = ex.make_model(cs.FEAT_DIM, 32, cs.CLASSES, [5, 3], b, cuda,
                          torch.Generator().manual_seed(0))
    out.append((gtt.loader.DistScanTrainer(loader, model, cs.CLASSES,
                                           chunk_size=2, capture=capture),
                gtt.models.create_train_state(model)))
  return out


def test_dist_scan_trainer_captured_matches_eager(cuda):
  """The captured DistScanTrainer against the eager one from one start,
  three epochs of 5 steps in chunks of 2 (a tail chunk of 1): losses and
  parameters within rtol 1e-4, launch counters equal (K3 P x hops and K1
  3P a step, one dist_step_keys a chunk), the published feature counters
  exact, the graphs' keys the plain keys of the epoch's last chunks, and
  the third epoch (replays only) under ``set_sync_debug_mode('error')``
  but for its one epoch-end publish."""
  (cap, cstate), (eag, estate) = _dist_scan_pair(cuda)
  assert cap.capture and not eag.capture
  let_through = _publish_let_through(cap.loader)
  for epoch in range(3):
    count0 = cap._sampler._call_count + 1
    counts, stats = {}, {}
    for name, t, st in (('cap', cap, cstate), ('eag', eag, estate)):
      ops.reset_launch_counts()
      if name == 'cap' and epoch == 2:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
      try:
        with published({0: t._feat}) as stats[name]:
          st, losses, _ = t.run_epoch(st)
      finally:
        torch.cuda.set_sync_debug_mode('default')
      torch.cuda.synchronize()
      counts[name] = ops.launch_counts()
      if name == 'cap':
        cstate, closs = st, losses
      else:
        estate, eloss = st, losses
    assert counts['cap'] == counts['eag']
    assert counts['cap']['sample_hop'] == 4 * 2 * 5
    assert counts['cap']['gather_rows'] == 3 * 4 * 5
    assert counts['cap']['dist_step_keys'] == 3
    torch.testing.assert_close(closs, eloss, rtol=1e-4, atol=0)
    assert stats['cap'] == stats['eag'] and stats['cap'][0]['lookups'] > 0
    assert len(let_through) == epoch + 1
    want = gtt.random.dist_step_keys_plain(
        cap._sampler._key, count0 + torch.arange(5, dtype=torch.int64), 4, 2)
    if 1 in cap._graphs:
      assert torch.equal(cap._graphs[1].keys.cpu(), want[4:])
    if 2 in cap._graphs:
      assert torch.equal(cap._graphs[2].keys.cpu(), want[2:4])
  assert sorted(cap._graphs) == [1, 2]
  for a, b in zip(cap.model.parameters(), eag.model.parameters()):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_dist_scan_trainer_refuses_capture_with_a_fractional_exchange(cuda):
  (t, _), _ = _dist_scan_pair(cuda, frac=None)
  loader = t.loader
  loader.sampler.bucket_frac = 2.0
  with pytest.raises(ValueError, match='bucket_frac=None'):
    gtt.loader.DistScanTrainer(loader, t.model, 3, chunk_size=2)
  eager = gtt.loader.DistScanTrainer(loader, t.model, 3, chunk_size=2,
                                     capture=False)
  assert not eager.capture


def test_dist_staging_slot_waits_for_its_copy_event(cuda, tmp_path):
  """H7a for the distributed stager on the card: a ``[P, cap]`` slab
  copied to the device behind a long kernel and acked with the copy's
  event; the chunk sharing its ring slot is not staged until the event
  has completed, and the device copy holds the first slab's bytes."""
  from graphlearn_tpu_torch import distributed as gdist
  p, n = 2, 64
  feat = np.random.default_rng(5).standard_normal((n, 4)).astype(np.float32)
  pb = (np.arange(n) % p).astype(np.int32)
  parts = [(np.nonzero(pb == i)[0], feat[pb == i]) for i in range(p)]
  store = gtt.storage.TieredDistFeature(
      p, parts, pb, mesh=gdist.ShardMesh(p, cuda),
      spill_dir=str(tmp_path / 'sp'), hot_prefix_rows=4)
  n_max = store.n_max
  enc = [np.array([4, 5, n_max + 6, n_max + 7]),
         np.array([8, n_max + 9]), np.array([10, 11, n_max + 12])]
  stager = gtt.storage.DistChunkStager(store, max_ahead=1, timeout_s=30.0)
  stager.begin_epoch(enc)
  ids0, rows0 = stager.take(0)
  assert rows0.is_pinned() and ids0.is_pinned()
  assert ids0.shape == (p, 2) and rows0.shape == (p, 2, 4)
  want0 = rows0.clone()
  dst = torch.empty(rows0.shape, device=cuda)
  torch.cuda._sleep(2_000_000_000)           # ~1 s of spin ahead of it
  dst.copy_(rows0, non_blocking=True)
  ev = torch.cuda.Event()
  ev.record()
  stager.ack(0, ev)
  stager.take(1)                             # submits chunk 2 (slot 0)
  time.sleep(0.2)
  assert not ev.query() and 2 not in stager.stage_done_t
  ids2, rows2 = stager.take(2)               # staged once the event is done
  assert ev.query() and not stager.degraded
  assert ids2.data_ptr() == ids0.data_ptr()
  torch.cuda.synchronize()
  assert torch.equal(dst.cpu(), want0)
  assert torch.equal(want0[0], torch.from_numpy(
      store.cpu_get(store.feat_ids[0, [4, 5]]).numpy()))
  assert ids2[0].tolist() == [10, 11] and ids2[1].tolist()[0] == 12
  stager.close()


def _local_shard(n_owned, e, pad, seed=0):
  """A shard's local CSR: ``n_owned`` ascending global row ids (every
  third id) padded with INT32_MAX to ``n_owned + pad`` rows, ``e`` edges
  with zipf columns, row-sorted indices (-1 padded by 3)."""
  rng = np.random.default_rng(seed)
  rows = np.sort(rng.integers(0, max(n_owned, 1), e)) if n_owned else \
      np.zeros(0, np.int64)
  cols = rng.zipf(1.5, rows.shape[0]) % (3 * max(n_owned, 1) + 7)
  rid = np.full(n_owned + pad, np.iinfo(np.int32).max, np.int32)
  rid[:n_owned] = np.arange(n_owned) * 3
  ptr = np.zeros(n_owned + pad + 1, np.int32)
  np.cumsum(np.bincount(rows, minlength=n_owned + pad), out=ptr[1:])
  order = np.lexsort((cols, rows))
  idx = np.full(rows.shape[0] + 3, -1, np.int32)
  idx[:rows.shape[0]] = cols[order]
  return [torch.as_tensor(a) for a in (rid, ptr, idx)]


@pytest.mark.parametrize('n_owned,e,pad,num,num_dst', [
    (70_000, 300_000, 5, 512, 1_000_003), (65_537, 100_000, 0, 300, 9),
    (12, 60, 3, 64, 40), (0, 0, 6, 32, 100), (5, 0, 2, 16, 1),
    (1_000, 5_000, 70_000, 64, 5_000), (32, 100, 0, 16, 50),
    (33, 100, 31, 16, 50)])
@pytest.mark.parametrize('strict', [False, True])
def test_negative_sample_local_kernel_matches_plain(cuda, n_owned, e, pad,
                                                    num, num_dst, strict):
  """The negative kernel's shard-local entry: the owned-row count it
  reads on the device, its candidates (randint over span 2**30 reduced
  by the count, past 65,536 owned rows) and the taken negatives equal
  the plain version's on the same key, on a shard that owns no row
  (every slot invalid, ids -1) and one with no edge, one mostly padding
  and row-id counts about the count search's 32 probes a step; one
  launch a call, no host sync; a host key and the same key on the device
  agree."""
  rid, ptr, idx = _local_shard(n_owned, e, pad)
  grid, gptr, gidx = (t.to(cuda) for t in (rid, ptr, idx))
  key = gtt.random.fold_in(gtt.random.PRNGKey(5), n_owned)
  dkey = gtt.random.to_device(key, cuda)
  before = ops.launch_counts()['negative_sample_local']
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = ops.random_negative_sample_local(grid, gptr, gidx, num_dst, num,
                                           dkey, strict=strict)
    cand = ops.negative.local_candidates(grid, gptr, gidx, num_dst, num * 5,
                                         dkey)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  assert ops.launch_counts()['negative_sample_local'] == before + 2
  plain = ops.negative.local_candidates_plain(grid, gptr, gidx, num_dst,
                                              num * 5, dkey)
  cpu = ops.negative.local_candidates_plain(rid, ptr, idx, num_dst, num * 5,
                                            key)
  for a, b, c in zip(cand, plain, cpu):
    assert torch.equal(a, b) and torch.equal(a.cpu(), c)
  assert int(cand[3]) == n_owned
  want = ops.random_negative_sample_local_plain(rid, ptr, idx, num_dst, num,
                                                key, strict=strict)
  for a, b in zip(got, want):
    assert torch.equal(a.cpu(), b)
  if n_owned == 0:
    assert not got[2].any() and bool((got[0] == -1).all())
  host = ops.random_negative_sample_local(grid, gptr, gidx, num_dst, num,
                                          key, strict=strict)
  for a, b in zip(got, host):
    assert torch.equal(a, b)


def test_dist_link_batch_on_card_has_no_host_sync(cuda):
  """A distributed link batch (binary, ``neg_strict``, full-width
  exchanges) over P = 4 shards of a 20,000-node graph on one card, made
  under ``set_sync_debug_mode('error')`` (chip_smoke.py's dist_more
  helpers at a small size): equal to the CPU sampler's on the same seed
  edges and keys, with the local negative kernel once per shard."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  from graphlearn_tpu_torch.sampler import NegativeSampling
  cs = _chip_smoke()
  n, p, b = 20000, 4, 64
  ei, feats, _ = cs.make_graph(n, 25)
  pb = cs.dist_book(n, p)
  parts, fparts = ex.partition_in_memory(ei, feats, pb, p)
  dg = gdist.DistGraph(p, 0, parts, pb)
  mesh = gdist.ShardMesh(p, cuda)
  ds = gdist.DistDataset(p, 0, dg, gdist.DistFeature(
      p, fparts, pb, mesh, split_ratio=0.1, bucket_frac=None))
  pick = np.random.default_rng(3).choice(ei.shape[1], p * b * 3,
                                         replace=False)
  loader = gdist.DistLinkNeighborLoader(
      ds, [10, 5], ei[:, pick], batch_size=b, seed=0, mesh=mesh,
      neg_sampling=NegativeSampling('binary', 1), dedup='tree',
      bucket_frac=None, neg_strict=True)
  host = gdist.DistNeighborSampler(dg, [10, 5], gdist.ShardMesh(p, 'cpu'),
                                   seed=0, dedup='tree', bucket_frac=None,
                                   neg_strict=True)
  blocks = list(loader._index_blocks())
  it = iter(loader)
  next(it)
  torch.cuda.synchronize()
  ops.reset_launch_counts()
  torch.cuda.set_sync_debug_mode('error')
  try:
    batch = next(it)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  counts = ops.launch_counts()
  assert counts['negative_sample_local'] == p
  assert counts['sample_hop'] == 2 * p and counts['gather_rows'] == 2 * p
  idx, mask = blocks[1]
  cs.dmore_link_check(torch, host, loader, idx, mask, 2, batch,
                      torch.as_tensor(feats).to(cuda), 'binary')


def test_typed_dist_scan_captured_matches_eager(cuda):
  """A captured typed ``DistScanTrainer`` (the two-type ring of the JAX
  tests at P = 2 on one card, RGNN, 4 steps in chunks of 2) against the
  eager one from one start: losses and parameters within rtol 1e-4, the
  launch counters equal (K3 once per plan item a step and shard, one
  dist_step_keys a chunk), the per-type published feature counters
  exact, the second epoch (replays only) under
  ``set_sync_debug_mode('error')`` but for its one epoch-end publish."""
  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.typing import GraphPartitionData
  n, p = 40, 2
  et1, et2 = ('u', 'to', 'v'), ('v', 'back', 'u')
  ui = np.arange(n)
  e1 = np.stack([np.concatenate([ui, ui]),
                 np.concatenate([ui, (ui + 1) % n])])
  e2 = np.stack([ui, (ui + 2) % n])
  pb = {'u': (ui % p).astype(np.int32), 'v': ((ui + 1) % p).astype(np.int32)}
  parts = [{et1: GraphPartitionData(edge_index=e1[:, pb['u'][e1[0]] == q],
                                    eids=np.nonzero(pb['u'][e1[0]] == q)[0]),
            et2: GraphPartitionData(edge_index=e2[:, pb['v'][e2[0]] == q],
                                    eids=np.nonzero(pb['v'][e2[0]] == q)[0])}
           for q in range(p)]
  fan = {et1: [2, 2], et2: [1, 1]}
  msg = (gtt.typing.reverse_edge_type(et1), gtt.typing.reverse_edge_type(et2))
  runs = []
  for capture in (True, False):
    mesh = gdist.ShardMesh(p, cuda)
    feats = {t: gdist.DistFeature(
        p, [(np.nonzero(pb[t] == q)[0],
             np.nonzero(pb[t] == q)[0][:, None].astype(np.float32) *
             np.ones((1, 4), np.float32)) for q in range(p)], pb[t], mesh,
        split_ratio=0.25, bucket_frac=None) for t in ('u', 'v')}
    ds = gdist.DistDataset(p, 0, gdist.DistHeteroGraph(p, 0, parts, pb),
                           feats, node_labels={'u': ui % 3, 'v': ui % 3})
    loader = gdist.DistNeighborLoader(ds, fan, ('u', np.arange(16)),
                                      batch_size=2, seed=0, mesh=mesh,
                                      bucket_frac=None)
    model = gtt.models.RGNN(msg, {'u': 4, 'v': 4}, 8, 3, out_ntype='u',
                            device=cuda,
                            generator=torch.Generator().manual_seed(0))
    t = gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=2,
                                   capture=capture)
    assert t.capture == capture
    runs.append([t, gtt.models.create_train_state(model)])
  items = sum(len(h) for h in runs[0][0]._sampler._hetero_plan({'u': 2})[1])
  let_through = _publish_let_through(runs[0][0].loader)
  for epoch in range(2):
    out = []
    for i, (t, st) in enumerate(runs):
      ops.reset_launch_counts()
      torch.cuda.synchronize()
      if i == 0 and epoch == 1:
        torch.cuda.set_sync_debug_mode('error')
      try:
        with published(t._feat) as stats:
          st, losses, _ = t.run_epoch(st)
      finally:
        torch.cuda.set_sync_debug_mode('default')
      torch.cuda.synchronize()
      runs[i][1] = st
      out.append((losses, ops.launch_counts(), stats))
    assert out[0][1] == out[1][1]
    assert out[0][1]['sample_hop'] == 4 * p * items
    assert out[0][1]['dist_step_keys'] == 2
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=0)
    assert out[0][2] == out[1][2]
    assert all(st['lookups'] > 0 for st in out[0][2].values())
  assert len(let_through) == 2
  for a, b in zip(runs[0][0].model.parameters(),
                  runs[1][0].model.parameters()):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------- the remote stack


def _remote_small(cuda):
  rng = np.random.default_rng(8)
  n = 3000
  ei = np.stack([rng.integers(0, n, 24000), rng.integers(0, n, 24000)])
  ds = gtt.data.Dataset(device=cuda)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(rng.standard_normal((n, 24)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, 5, n))
  return ds


def test_mp_workers_on_card_match_parent_sampler(cuda):
  """Two spawned workers sample on the card from the IPC-shared dataset:
  each batch equals the parent's own card sampler at that worker's seed
  and call index, and the workers' launch counts (three level launches
  a level plus one a batch, one K1 a batch) arrive through
  ``worker_metrics()``."""
  ds = _remote_small(cuda)
  seeds, bs, fan = np.arange(0, 3000, 11), 64, [5, 3]
  loader = gtt.distributed.MpDistNeighborLoader(
      ds, fan, seeds, batch_size=bs, num_workers=2, seed=3)
  shares = np.array_split(seeds, 2)
  try:
    got = {}
    for b in loader:
      ids = b.batch.cpu().numpy()[:b.batch_size]
      w = 0 if ids[0] in shares[0] else 1
      j = int(np.nonzero(shares[w] == ids[0])[0][0]) // bs
      got[(w, j)] = b
    assert len(got) == len(loader)
    for (w, j), b in got.items():
      s = gtt.sampler.NeighborSampler(ds.graph, fan, device=cuda,
                                      seed=3 * 1000003 + w)
      s._call_count = j
      out = s.sample_from_nodes(
          gtt.sampler.NodeSamplerInput(shares[w][j * bs:(j + 1) * bs]),
          batch_cap=bs)
      for got_t, want in ((b.node, out.node), (b.edge_mask, out.edge_mask),
                          (b.edge_index, torch.stack([out.row, out.col])),
                          (b.x, ds.node_features[out.node])):
        assert torch.equal(got_t, want)
      assert b.num_nodes == int(out.num_nodes)
    snap = None
    for _ in range(600):
      snap = loader.worker_metrics()
      if snap is not None and snap['workers'] == [0, 1]:
        break
      time.sleep(0.05)
    assert snap['workers'] == [0, 1]
    n = len(loader)
    assert snap['launches']['sample_level'] == n * (3 * len(fan) + 1)
    assert snap['launches']['gather_rows'] == n
    assert snap['launches']['sample_hop'] == 0
  finally:
    loader.shutdown()
  assert not any(p.is_alive() for p in loader.producer._procs)


def test_card_batch_through_the_ring_bit_for_bit(cuda):
  from graphlearn_tpu_torch.channel import ShmChannel
  from graphlearn_tpu_torch.distributed import message
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  ds = _remote_small(cuda)
  s = gtt.sampler.NeighborSampler(ds.graph, [5, 3], device=cuda, seed=1)
  out = s.sample_from_nodes(gtt.sampler.NodeSamplerInput(np.arange(64)),
                            batch_cap=64)
  x, y = _batch_message(ds, out, True, False)
  ch = ShmChannel(shm_size=64 << 20)
  try:
    ch.send(message.output_to_message(out, x, y))
    b = message.message_to_data(ch.recv(timeout_ms=10000), device=cuda)
  finally:
    ch.close()
  for got, want in ((b.node, out.node), (b.edge_mask, out.edge_mask),
                    (b.edge_index, torch.stack([out.row, out.col])),
                    (b.x, x), (b.y, y), (b.batch, out.batch)):
    assert got.device.type == 'cuda' and got.dtype == want.dtype
    assert torch.equal(got, want)
  assert b.num_nodes == int(out.num_nodes)


_PRODUCER_COMMON = """
import numpy as np

import graphlearn_tpu_torch as gtt


def dataset():
  rng = np.random.default_rng(8)
  n = 3000
  ds = gtt.data.Dataset(device='cuda')
  ds.init_graph(np.stack([rng.integers(0, n, 24000),
                          rng.integers(0, n, 24000)]), num_nodes=n)
  ds.init_node_features(rng.standard_normal((n, 24)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, 5, n))
  return ds
"""

_PRODUCERS = {
    # the mp loader's producer is this process
    'mp': """
def main():
  loader = gtt.distributed.MpDistNeighborLoader(
      dataset(), [5, 3], np.arange(0, 3000, 11), batch_size=64,
      num_workers=2, seed=3)
  try:
    print('batches', sum(1 for _ in loader), flush=True)
  finally:
    loader.shutdown()
""",
    # a DistServer's producers, created and destroyed over its RPC
    'server': """
def main():
  gd = gtt.distributed
  host, port = gd.init_server(1, 1, 0, dataset())
  gd.init_client(1, 1, 0, [(host, port)])
  opts = gd.RemoteDistSamplingWorkerOptions(server_rank=0, num_workers=2)
  loader = gd.RemoteDistNeighborLoader(
      [5, 3], np.arange(0, 3000, 11), batch_size=64, worker_options=opts,
      seed=1)
  try:
    print('batches', sum(1 for _ in loader), flush=True)
  finally:
    loader.shutdown()
  gd.shutdown_client()
  gd.wait_and_shutdown_server(timeout=60)
""",
}


@pytest.mark.parametrize('producer', sorted(_PRODUCERS))
def test_mp_producer_ends_with_every_ipc_handle_released(cuda, tmp_path,
                                                         producer):
  """A process that shared its card dataset with two workers ends
  cleanly, as the mp loader's process and as a server behind its RPC:
  the workers drop their CUDA IPC handles before they exit and the
  server's RPC threads hold no callee once it shut down, so torch never
  reports a producer ending before its shared CUDA tensors were
  released."""
  import os
  import subprocess
  import sys
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  script = tmp_path / 'producer.py'
  script.write_text(_PRODUCER_COMMON + _PRODUCERS[producer] +
                    "\nif __name__ == '__main__':\n  main()\n")
  proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                        text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=root))
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert 'batches' in proc.stdout
  assert 'shared CUDA tensors released' not in proc.stderr, \
      proc.stderr[-3000:]


# ---- the chunk-staged remote scan

_RSCAN_HANDLERS = ('create_block_producer', 'block_producer_num_batches',
                   'block_produce', 'block_fetch', 'destroy_block_producer',
                   'block_build_log', 'heartbeat', 'get_metrics', 'exit')


@contextlib.contextmanager
def _rscan_server(ds):
  """A ``DistServer`` over ``ds`` behind an ``RpcServer`` in this process,
  the port's client connected to it."""
  from graphlearn_tpu_torch.distributed import dist_client
  srv = gtt.distributed.DistServer(ds)
  rpc = gtt.distributed.RpcServer(
      handlers={h: getattr(srv, h) for h in _RSCAN_HANDLERS})
  gtt.distributed.init_client(1, 1, 0, [(rpc.host, rpc.port)])
  try:
    yield srv
  finally:
    if dist_client._client is not None:
      dist_client._client.close()
      dist_client._client = None
    srv.exit()
    rpc.shutdown()


def _rscan_model(cuda, b, fan, seed=0):
  no, eo = gtt.models.merge_hop_offsets(b, fan)
  return gtt.models.GraphSAGE(
      24, 16, 5, num_layers=len(fan), hop_node_offsets=no,
      hop_edge_offsets=eo, merge_dense=True, fanouts=fan, device=cuda,
      generator=torch.Generator().manual_seed(seed))


def _rscan_tensors(model, state):
  ps = list(model.parameters())
  return ps + [v for p in ps for v in state.optimizer.state[p].values()
               if torch.is_tensor(v)]


def test_remote_scan_captured_chunk_equals_eager(cuda):
  """A captured ``RemoteScanTrainer`` epoch (5 steps at K = 2: chunks of
  2, 2 and a tail of 1) taking up an eager trainer's parameters and Adam
  state at each chunk start (merge training is chaotic on the card, so
  the chunks start from a common state): its chunk losses within rtol
  1e-4 of the eager ones; the first chunk eager (the warm-up), then one
  upload a chunk and one replay for each later chunk, graphs of lengths
  2 and 1."""
  from graphlearn_tpu_torch.models import train
  ds = _remote_small(cuda)
  b, fan = 64, [5, 3]
  seeds = np.arange(0, 3000, 7)[:5 * b]
  opts = gtt.distributed.RemoteDistSamplingWorkerOptions(server_rank=0)
  with _rscan_server(ds):
    start = _rscan_model(cuda, b, fan).state_dict()
    trainers = []
    for capture in (False, True):
      m = _rscan_model(cuda, b, fan)
      m.load_state_dict(start)
      trainers.append(gtt.distributed.RemoteScanTrainer(
          fan, seeds, m, 5, batch_size=b, chunk_size=2, worker_options=opts,
          seed=1, device=cuda, capture=capture))
    eag, cap = trainers
    assert cap.capture and not eag.capture
    se = train.create_train_state(eag.model)
    sc = train.create_train_state(cap.model)
    boundary = {}
    eag.stage_hook = lambda c, s, k: boundary.__setitem__(
        c, [t.detach().clone() for t in _rscan_tensors(eag.model, se)])

    def take(c, s, k):
      mine = _rscan_tensors(cap.model, sc)
      if len(mine) == len(boundary[c]):
        with torch.no_grad():
          torch._foreach_copy_(mine, boundary[c])
    cap.stage_hook = take
    try:
      se, le, _ = eag.run_epoch(se)
      sc, lc, _ = cap.run_epoch(sc)
      torch.cuda.synchronize()
      torch.testing.assert_close(lc, le, rtol=1e-4, atol=0)
      assert (cap.uploads, cap.replays) == (3, 2)
      assert (eag.uploads, eag.replays) == (3, 0)
      assert sorted(cap._graphs) == [1, 2]
      assert all(ok for _, ok in cap._stager.refills)
      assert cap._stager.slot_bytes == 2 * cap._layout.nbytes
      timings = cap.chunk_timings()
      assert [t['k'] for t in timings] == [2, 2, 1]
      assert all(t['upload_ms'] is not None and t['device_ms'] > 0
                 for t in timings)
    finally:
      for t in trainers:
        t.shutdown()
        t.drop_graphs()


def test_remote_scan_replayed_epoch_makes_no_host_sync(cuda):
  """A second captured epoch is one upload and one replay a chunk, with
  no host sync in it (its frames produced on the server beforehand, so
  the in-process server's own copies lie outside the window); its
  losses equal an eager trainer's from the same weights within rtol
  1e-4 after the eager epoch took up the captured state."""
  from graphlearn_tpu_torch.models import train
  ds = _remote_small(cuda)
  b, fan = 64, [5, 3]
  seeds = np.arange(1, 3000, 7)[:5 * b]
  opts = gtt.distributed.RemoteDistSamplingWorkerOptions(server_rank=0)
  with _rscan_server(ds):
    cap = gtt.distributed.RemoteScanTrainer(
        fan, seeds, _rscan_model(cuda, b, fan), 5, batch_size=b,
        chunk_size=2, worker_options=opts, seed=2, device=cuda)
    try:
      state = train.create_train_state(cap.model)
      state, _, _ = cap.run_epoch(state)
      (st,) = cap._streams
      for start, k in ((0, 2), (2, 2), (4, 1)):
        gtt.distributed.request_server(0, 'block_produce', st['pid'], 1,
                                       start, k)
      torch.cuda.synchronize()
      with _no_sync_allowed():
        state, losses, accs = cap.run_epoch(state)
      torch.cuda.synchronize()
      assert (cap.uploads, cap.replays) == (3, 3)
      assert losses.shape == accs.shape == (5,)
      assert bool(torch.isfinite(losses).all())
      assert state.step == 10
    finally:
      cap.shutdown()
      cap.drop_graphs()


def test_remote_stager_slot_waits_for_its_copy_event(cuda):
  """H7a for the remote stager: a slot copied to the device behind a
  long kernel and acked with the copy's event is not refilled until the
  event completed, and the device copy holds the first frame's bytes."""
  frames = {c: dict(v=np.full((4, 1000), c + 1, np.float32))
            for c in range(3)}

  def pack(frame, buf):
    buf.numpy().view(np.float32)[:4000] = frame['v'].reshape(-1)
    return {}

  stager = gtt.distributed.RemoteBlockStager(
      frames.__getitem__, max_ahead=1, timeout_s=30.0, pack_fn=pack,
      slot_bytes_fn=lambda f: 16000, pin=True)
  stager.begin_epoch(3)
  slab0 = stager.take(0)
  buf = slab0.slot.buf
  assert buf.is_pinned() and stager.slot_bytes == 16000
  dst = torch.empty(buf.shape, dtype=torch.uint8, device=cuda)
  torch.cuda._sleep(2_000_000_000)           # ~1 s of spin ahead of it
  dst.copy_(buf, non_blocking=True)
  ev = torch.cuda.Event()
  ev.record()
  stager.ack(0, ev)                          # submits chunk 1 (slot 0)
  time.sleep(0.2)
  assert not ev.query() and not stager.has_frame(1)
  slab1 = stager.take(1)                     # packed once the event is done
  assert ev.query() and not stager.degraded
  assert slab1.slot.buf.data_ptr() == buf.data_ptr()
  torch.cuda.synchronize()
  got = dst.cpu().numpy().view(np.float32)
  assert (got == 1).all()
  assert (buf.numpy().view(np.float32) == 2).all()
  assert stager.refills == [(0, True), (1, True)]
  stager.close()


def test_server_block_launch_counts_from_rpc_threads(cuda):
  """Block frames built on the server's RPC threads, from eight client
  threads at once over four streams: the launch counters stay exact
  (K4 three a level and one a batch, K1 one a batch) and every frame
  equals the same block built alone."""
  import concurrent.futures

  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  ds = _remote_small(cuda)
  b, fan = 32, [4, 3]
  cfg = SamplingConfig(SamplingType.NODE, fan, b, False, False, False, True,
                       False, False, 'out', 3)
  with _rscan_server(ds) as srv:
    pids = [gtt.distributed.request_server(
        0, 'create_block_producer', np.arange(s, 3000, 5)[:6 * b], cfg,
        None) for s in range(4)]
    blocks = [(pid, start) for pid in pids for start in range(0, 6, 2)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
      got = list(pool.map(
          lambda pb: gtt.distributed.request_server(
              0, 'block_fetch', pb[0], 0, pb[1], 2), blocks))
    counts = ops.launch_counts()
    batches = 2 * len(blocks)
    assert counts['sample_level'] == batches * (3 * len(fan) + 1)
    assert counts['gather_rows'] == batches
    assert counts['sample_hop'] == 0
    for (pid, start), frame in zip(blocks, got):
      alone = srv._block_producers[pid].build_frame(0, start, 2)
      assert sorted(alone) == sorted(frame)
      for k in frame:
        np.testing.assert_array_equal(frame[k], alone[k], err_msg=k)


# ------------------------------------------------------------ observability


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_flight_record_of_a_captured_epoch_makes_no_host_sync(
    cuda, mode, tmp_path, monkeypatch):
  """A replayed captured epoch with the flight and span logs on and a
  dispatch region open runs under ``set_sync_debug_mode('error')``; its
  record passes logcheck, counts a ``scan_chunk`` dispatch per replay
  and no capture, and its ``epoch.chunk`` spans nest under its
  ``epoch.run``."""
  from graphlearn_tpu_torch.metrics import flight, logcheck, spans
  from graphlearn_tpu_torch.utils import trace
  s = _Small(cuda, mode)
  tr, state = s.trainer(gtt.loader.ScanTrainer, chunk_size=2)
  state, _, _ = tr.run_epoch(state)        # warm-up and capture
  torch.cuda.synchronize()
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'run.jsonl'))
  monkeypatch.setenv('GLT_SPAN_LOG', str(tmp_path / 'spans.jsonl'))
  with trace.count_dispatches() as dc:
    with _no_sync_allowed():
      state, _, _ = tr.run_epoch(state)
  (rec,) = flight.read_records()
  assert logcheck.validate_flight_record(rec) == []
  assert rec['dispatch']['scan_chunk'] == dc.counts['scan_chunk'] == 2
  assert rec['programs'] == {'scan_chunk': {'dispatches': 2}}
  tree = spans.build_tree(spans.read_log())
  (root,) = tree['roots']
  assert tree['spans'][root]['name'] == 'epoch.run'
  assert [tree['spans'][c]['name'] for c in tree['children'][root]] == \
      ['epoch.chunk'] * 2
  assert logcheck.check_file(str(tmp_path / 'spans.jsonl')) == []


def test_capture_counts_per_chunk_length_and_recapture_diff(cuda):
  """The program observatory counts a capture per chunk length (3 and a
  tail of 1) over the first epochs and none in a replayed one; a new
  rate (the graphs froze the old one) is a recapture, a retrace whose
  diff names the rate and not the chunk."""
  from graphlearn_tpu_torch.metrics import programs
  from graphlearn_tpu_torch.models import train
  s = _Small(cuda, 'tree')
  tr, state = s.trainer(gtt.loader.ScanTrainer, chunk_size=3)
  reg = programs.default_program_registry()
  base = reg.compile_count('scan_chunk')
  state, _, _ = tr.run_epoch(state)          # warm-up (3), capture 1
  state, _, _ = tr.run_epoch(state)          # capture 3, replay 1
  assert reg.compile_count('scan_chunk') - base == 2
  assert sorted(tr._graphs) == [1, 3]
  with programs.retrace_budget('scan_chunk', 0):
    tr.run_epoch(state)
  assert reg.compile_count('scan_chunk') - base == 2
  tr2, state2 = s.trainer(gtt.loader.ScanTrainer, chunk_size=2)
  tr2.run_epoch(state2)                      # warm-up, capture 2
  tr2.run_epoch(train.create_train_state(tr2.model, lr=7e-4))
  assert reg.compile_count('scan_chunk') - base == 4
  ev = programs.last_compile('scan_chunk')
  assert ev.index >= 3 and '-> static:group0.lr=0.0007' in ev.diff
  assert 'k=' not in ev.diff and 'seeds' not in ev.diff
  torch.cuda.synchronize()


def test_span_tree_across_server_and_client_on_card(cuda):
  """A block fetched from a loopback ``DistServer`` on the card under a
  request id reads back from ``scrape_all()`` and the local ring as one
  tree: rpc.client.request -> rpc.server.handle -> remote.block_stage,
  the block span carrying the build's phase times."""
  from graphlearn_tpu_torch import metrics
  from graphlearn_tpu_torch.metrics import spans
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  ds = _remote_small(cuda)
  cfg = SamplingConfig(SamplingType.NODE, [4, 3], 32, False, False, False,
                       True, False, False, 'out', 3)
  with _rscan_server(ds):
    pid = gtt.distributed.request_server(
        0, 'create_block_producer', np.arange(0, 3000, 7)[:96], cfg, None)
    with spans.new_trace() as req:
      frame = gtt.distributed.request_server(0, 'block_fetch', pid, 0, 0,
                                             2)
    scr = metrics.scrape_all(timeout=30.0)
  assert frame['x'].shape[0] == 2
  rows = spans.dedupe(spans.from_scrape(scr, trace=req) +
                      spans.export(trace=req))
  tree = spans.build_tree(rows)
  assert not tree['orphans'] and len(tree['roots']) == 1
  root = tree['spans'][tree['roots'][0]]
  (handle,) = tree['children'][root['span']]
  (stage,) = tree['children'][handle]
  assert [root['name'], tree['spans'][handle]['name'],
          tree['spans'][stage]['name']] == [
              'rpc.client.request', 'rpc.server.handle',
              'remote.block_stage']
  attrs = tree['spans'][stage]['attrs']
  assert attrs['k'] == 2 and attrs['bytes'] > 0
  assert 0 <= attrs['sample_ms'] <= tree['spans'][stage]['dur_ms']


# ------------------------------------------------------------- the tuner


def _tune_small(cuda, steps):
  """A card dataset whose seed pool is ``steps`` batches of 16."""
  rng = np.random.default_rng(21)
  n, f = 600, 8
  ei = np.stack([rng.integers(0, n, 6000), rng.integers(0, n, 6000)])
  ds = gtt.data.Dataset(device=cuda)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(rng.standard_normal((n, f)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, 4, n))
  cfg = dict(fanouts=[4, 3], input_nodes=rng.permutation(n)[:16 * steps],
             batch_size=16)
  return ds, cfg


def test_tune_at_an_epoch_of_exactly_k_steps_qualifies_and_rejects_the_probe(
    cuda):
  """An epoch of exactly K steps: the probe epoch is one chunk, the
  captured trainer's eager warm-up, so the compile phase runs it twice
  and captures the one chunk length; every candidate qualifies with no
  steady capture, and the retrace probe is rejected with a diff naming
  the chunk length. From the second candidate on, each hands back what it
  allocated."""
  from graphlearn_tpu_torch import tune as gtune
  ds, cfg = _tune_small(cuda, 4)
  caps, _ = gtune.probes.probe_frontier_caps(ds.graph, [4, 3], 16,
                                             input_nodes=cfg['input_nodes'])
  cands = gtune.default_candidates(caps, exact=False)
  cands.append(gtune.retrace_probe_candidate(cands[0]))
  art = gtt.tune(ds, cfg, candidates=cands)
  assert art.choices['chunk_k'] == 4
  recs = {r['name']: r for r in art.evidence if r.get('kind') == 'candidate'}
  assert len(recs) == len(cands)
  for i, (name, r) in enumerate(recs.items()):
    if i:   # the first also places what the dataset and process keep
      assert abs(r['mem_after_mb'] - r['mem_before_mb']) < 16, r
    if name.endswith('retrace_probe'):
      assert not r['qualified']
      assert 'static:k=4 -> static:k=2' in r['retrace_diff']
      continue
    assert r['qualified'], r
    assert r['compile_epochs'] == 2 and r['probe_steps'] == 4
    assert r['compile_epoch_compiles']['scan_chunk'] == 1
    assert sum(r['steady_epoch_compiles'].values()) == 0
    assert r['peak_mb'] > 0


def test_a_strict_epoch_raises_on_a_read_back(cuda, monkeypatch):
  """Under GLT_STRICT=1 a captured epoch runs (its capture's and the
  seed pool's syncs let through), and a stage_hook's ``.item()`` inside
  the region raises; without GLT_STRICT the same hook runs. The merge
  guard's epoch-end flag read is outside the region."""
  for mode in ('tree', 'merge'):
    s = _Small(cuda, mode)
    tr, state = s.trainer(gtt.loader.ScanTrainer, chunk_size=2)
    monkeypatch.setenv('GLT_STRICT', '1')
    for _ in range(2):
      state, _, _ = tr.run_epoch(state)
    probe = torch.ones((), device=cuda)
    tr.stage_hook = lambda c, start, k: probe.item()
    with pytest.raises(RuntimeError, match='synchroniz'):
      tr.run_epoch(state)
    assert torch.cuda.get_sync_debug_mode() == 0
    monkeypatch.delenv('GLT_STRICT')
    state, losses, _ = tr.run_epoch(state)
    assert torch.isfinite(losses).all()


def test_serving_engine_config_routes_k2(cuda):
  """``ServingEngine(config=)`` with ``use_pallas_v2``: the artifact's
  buckets, the gather-v2 kernel once per engine batch, answers equal to
  the table."""
  from graphlearn_tpu_torch import metrics
  n = 5000
  table = np.random.default_rng(3).standard_normal((n, 12)).astype(
      np.float32)
  art = gtt.tune.TuneArtifact(dict(serving_buckets=[16, 64, 256],
                                   use_pallas_v2=True, gather2_block_rows=128,
                                   gather2_run_span=4),
                              dict(num_nodes=n))
  store = gtt.serving.EmbeddingStore(table, device=cuda)
  b0 = metrics.default_registry().counter_value('serving.batches')
  before = ops.launch_counts()['gather_runs']
  with gtt.serving.ServingEngine(store, config=art) as eng:
    assert eng.buckets == (16, 64, 256)
    for ids in (np.arange(7), np.arange(100, 300), np.array([n - 1, 0])):
      np.testing.assert_array_equal(eng.submit(ids).result(timeout=30),
                                    table[ids])
  batches = metrics.default_registry().counter_value('serving.batches') - b0
  assert ops.launch_counts()['gather_runs'] - before == batches == 3


# ------------------------------------------------ several cards (a group)


def _group(cuda, across):
  """Every card, or ``cuda:0`` named three times (the sharded layout on
  one card); ``across`` needs two cards or more and skips without."""
  cards = torch.cuda.device_count()
  if across:
    if cards < 2:
      pytest.skip('needs two cards or more (a group across cards)')
    return [torch.device('cuda', i) for i in range(cards)]
  return [torch.device('cuda', 0)] * 3


@pytest.mark.parametrize('across', [False, True])
@pytest.mark.parametrize('dtype,width', _K1_WIDTHS)
@pytest.mark.parametrize('id_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('n_ids', _K1_IDS)
def test_gather_rows_sharded_kernel_matches_plain(cuda, across, dtype, width,
                                                  id_dtype, n_ids):
  """The sharded K1 entry over a group (one card named three times, or
  every card: rows read over NVLink) against its plain version and the
  whole table, bit for bit, ids clamped; one launch, none for no ids."""
  devices = _group(cuda, across)
  gen = torch.Generator().manual_seed(width)
  r = 333
  table = (torch.randn((r * len(devices), width), generator=gen) * 100).to(
      dtype)
  shards = [table[i * r:(i + 1) * r].to(d, copy=True)
            for i, d in enumerate(devices)]
  home = torch.device('cuda', 0)
  ops.peer.enable(devices)
  ptrs = ops.peer.pointer_table(shards, home)
  ids = _k1_ids(n_ids, ops.ShardedRows(shards, home), table.shape[0],
                id_dtype, gen, home).cpu()
  before = ops.launch_counts()['gather_rows_sharded']
  got = ops.gather_rows_sharded(shards, ptrs, ids.to(home))
  torch.cuda.synchronize()
  assert got.device == home
  assert torch.equal(got, ops.gather_rows_sharded_plain(shards,
                                                        ids.to(home)))
  assert torch.equal(got.cpu(), ops.gather_rows_plain(table, ids))
  assert ops.launch_counts()['gather_rows_sharded'] == before + 1
  empty = ops.gather_rows_sharded(shards, ptrs, ids[:0].to(home))
  assert empty.shape == (0, width)
  assert ops.launch_counts()['gather_rows_sharded'] == before + 1


@pytest.mark.parametrize('across', [False, True])
@pytest.mark.parametrize('rps,n_cold', [(300, 400), (1, 5), (50, 0)])
@pytest.mark.parametrize('pattern', _ID_PATTERNS)
def test_gather_unified_sharded_kernel_matches_plain(cuda, across, rps,
                                                     n_cold, pattern):
  """The sharded hot/cold entry (a group's shards, the tail mapped) against
  its plain version (the JAX store's mixed gather over the shards) and the
  whole table, bit for bit, over the id patterns of the one-block test;
  one launch, no host sync, the fetch counter the distinct cold rows."""
  from graphlearn_tpu_torch.ops import mapped
  devices = _group(cuda, across)
  gen = torch.Generator().manual_seed(rps)
  n_hot = rps * len(devices)
  table = torch.randn((n_hot + n_cold, 100), generator=gen)
  shards = [table[i * rps:(i + 1) * rps].to(d, copy=True)
            for i, d in enumerate(devices)]
  home = torch.device('cuda', 0)
  ops.peer.enable(devices)
  ptrs = ops.peer.pointer_table(shards, home)
  cold = mapped.empty((n_cold, 100), torch.float32)
  cold.copy_(table[n_hot:])
  if n_cold:
    mapped.register(cold, home)
  try:
    ids = _unified_ids(pattern, table.shape[0], n_hot, gen).to(home)
    before = ops.launch_counts()['gather_unified_sharded']
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
      got = ops.gather_rows_unified_sharded(shards, ptrs, cold, ids)
    finally:
      torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert ops.launch_counts()['gather_unified_sharded'] == before + 1
    assert int(ops.gather.unified_sharded_fetches) == _distinct_cold(
        ids, table.shape[0], n_hot)
    ids = ids.cpu()
    want, _ = ops.gather_rows_unified_sharded_plain(shards, cold,
                                                    ids.to(home))
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ops.gather_rows_plain(table, ids))
  finally:
    if n_cold:
      mapped.release(cold)


@pytest.mark.parametrize('across', [False, True])
@pytest.mark.parametrize('split', [1.0, 0.5])
def test_grouped_feature_on_card_matches_cpu(cuda, across, split):
  """A ``DeviceGroup`` store on the card against the same group of CPU
  devices: rows equal (FILL pads, the pad rows of a padded full split,
  the fill past them), one sharded launch a lookup and no host sync in
  it; ``device_table()`` usable at the full split; the in-process IPC
  round trip exact."""
  devices = _group(cuda, across)
  rng = np.random.default_rng(7)
  feat = rng.standard_normal((1001, 16)).astype(np.float32)
  store = gtt.data.Feature(feat, split_ratio=split, device_group_list=[
      gtt.data.DeviceGroup(0, devices)])
  host = gtt.data.Feature(feat, split_ratio=split, device_group_list=[
      gtt.data.DeviceGroup(0, ['cpu'] * len(devices))])
  store.lazy_init()
  assert store.unified.sharded
  ids_np = np.concatenate([rng.integers(0, 1001, 500),
                           [-1, 0, 1000, 1001, 5000]]).astype(np.int64)
  ids = torch.as_tensor(ids_np).to(store.device)
  name = 'gather_rows_sharded' if split == 1.0 else 'gather_unified_sharded'
  before = ops.launch_counts()[name]
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = store[ids]
  finally:
    torch.cuda.set_sync_debug_mode('default')
  torch.cuda.synchronize()
  assert ops.launch_counts()[name] == before + 1
  np.testing.assert_array_equal(got.cpu().numpy(), host[ids_np].numpy())
  assert (store.device_table() is not None) == (split == 1.0)
  clone = gtt.data.Feature.from_ipc_handle(store.share_ipc())
  np.testing.assert_array_equal(clone[ids].cpu().numpy(), got.cpu().numpy())



@pytest.mark.parametrize('across', [False, True])
def test_grouped_store_leaves_the_current_device(cuda, across):
  """Peer access between a group's cards and a grouped store given the
  unindexed ``'cuda'`` (the current card) leave the calling thread's
  current device as it was; the store's lookups then run on that card,
  its index pinned, and their rows land there."""
  devices = _group(cuda, across)
  torch.cuda.set_device(0)
  ops.peer.enable(devices)
  assert torch.cuda.current_device() == 0
  rng = np.random.default_rng(3)
  feat = rng.standard_normal((301, 8)).astype(np.float32)
  for split in (1.0, 0.5):
    store = gtt.data.Feature(feat, split_ratio=split, device=cuda,
                             device_group_list=[
                                 gtt.data.DeviceGroup(0, devices)])
    store.lazy_init()
    assert torch.cuda.current_device() == 0
    assert store.device == torch.device('cuda', 0)
    ids = rng.integers(0, 301, 200)
    got = store[ids]
    torch.cuda.synchronize()
    assert torch.cuda.current_device() == 0 and got.device == store.device
    np.testing.assert_array_equal(got.cpu().numpy(), feat[ids])


@pytest.mark.parametrize('across', [False, True])
def test_kernel_entries_leave_the_current_device(cuda, across):
  """Every single-device entry, on ``cuda:1`` (``across``; skips on one
  card) or on ``cuda:0``, with ``cuda:0`` current, leaves the calling
  thread's current device as it was: the mapping of a host tail and its
  release, the hot/cold gather, K1, K2, the fused hop, the fused level,
  both chunk-key entries, the draw, both negative entries and both
  probes; each result lands on the entry's card."""
  from graphlearn_tpu_torch.ops import mapped
  if across and torch.cuda.device_count() < 2:
    pytest.skip('needs two cards or more (an entry on cuda:1)')
  dev = torch.device('cuda', 1 if across else 0)
  torch.cuda.set_device(0)
  gen = torch.Generator().manual_seed(0)
  table = torch.randn((500, 32), generator=gen).to(dev)
  ids = torch.randint(0, 500, (300,), generator=gen).to(dev)
  cold = mapped.empty((300, 32), torch.float32)
  cold.copy_(table[200:].cpu())
  key = gtt.random.to_device(gtt.random.fold_in(gtt.random.PRNGKey(2), 1),
                             dev)
  counter = torch.zeros((), dtype=torch.int64, device=dev)
  g, seeds, mask = _hop_graph(dev, 5)
  lg, lseeds, lsmask, k, state, src, c = _level_inputs(dev, 'hubs')
  _, _, gptr, gidx = _neg_csr(dev, 300, 2000)
  grid, lptr, lidx = (t.to(dev) for t in _local_shard(300, 2000, 2))
  take = torch.randint(0, 1000, (1000,), dtype=torch.int32,
                       generator=gen).to(dev)
  calls = [
      ('host_register', lambda: mapped.register(cold, dev)),
      ('gather_unified', lambda: ops.gather_rows_unified(table[:200], cold,
                                                         ids)),
      ('gather_rows', lambda: ops.gather_rows_hbm(table, ids)),
      ('gather_runs', lambda: ops.gather_rows_hbm2(table, ids)),
      ('sample_hop', lambda: ops.sample_hop_fused(
          g.indptr, g.indices, None, seeds, mask, 5, key,
          meta=g.csr_meta)[0]),
      ('sample_level', lambda: ops.sample_level_fused(
          lg.indptr, lg.indices, None, lseeds, lsmask, k, key,
          _clone(state), src, meta=lg.csr_meta, prefix_cap=c)[2]),
      ('step_keys', lambda: ops.step_keys(key, counter, 3, 3)),
      ('dist_step_keys', lambda: ops.dist_step_keys(key, counter, 3, 4, 3)),
      ('uniform_draw', lambda: ops.draw.uniform(key, (1000,), device=dev)),
      ('negative_sample', lambda: ops.random_negative_sample(
          gptr, gidx, 300, 300, 64, key)[0]),
      ('negative_sample_local', lambda: ops.random_negative_sample_local(
          grid, lptr, lidx, 1000, 32, key)[0]),
      ('row_gather_probe', lambda: ops.row_gather_probe(table, ids)),
      ('smem_take', lambda: ops.smem_take(take, take)),
      ('host_unregister', lambda: mapped.release(cold))]
  try:
    for name, call in calls:
      out = call()
      torch.cuda.synchronize(dev)
      assert torch.cuda.current_device() == 0, name
      assert out is None or out.device == dev, name
  finally:
    if mapped.is_mapped(cold):
      mapped.release(cold)


def _grouped_dataset(cuda, rng_seed, devices):
  """A small graph's ``Dataset`` with its features in one table
  (``devices`` None) or a full split row-sharded over ``devices``."""
  rng = np.random.default_rng(rng_seed)
  n, f, c = 2000, 16, 5
  ei = np.stack([rng.integers(0, n, 30000), rng.zipf(1.5, 30000) % n])
  feats = rng.standard_normal((n, f)).astype(np.float32)
  ds = gtt.data.Dataset(device=cuda)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(feats, device_group_list=(
      None if devices is None else [gtt.data.DeviceGroup(0, devices)]))
  ds.init_node_labels(rng.integers(0, c, n))
  return ds, feats, rng.permutation(n)


@pytest.mark.parametrize('across', [False, True])
def test_neighbor_loader_collates_a_grouped_store(cuda, across):
  """The loader's fused collate over a grouped full split (2000 rows over
  one card named three times, padded to 2001, or over every card): its
  ``device_table()`` is the ``ShardedRows``, each batch one sharded
  launch and no K1 launch, the rows bit-equal to the same loader's over
  one table and to the features."""
  devices = _group(cuda, across)
  out = {}
  for name, group in (('one', None), ('group', devices)):
    ds, feats, perm = _grouped_dataset(cuda, 21, group)
    assert (type(ds.node_features.device_table()[0]) is ops.ShardedRows) \
        == (group is not None)
    loader = gtt.loader.NeighborLoader(ds, [5, 4], perm[:150],
                                       batch_size=48, shuffle=True, seed=3,
                                       dedup='tree', device=cuda)
    ops.reset_launch_counts()
    out[name] = [b.x for b in loader]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts['gather_rows_sharded'] == (4 if group else 0), counts
    assert counts['gather_rows'] == (0 if group else 4), counts
  for a, b in zip(out['one'], out['group']):
    assert torch.equal(a, b)
  assert len(out['group']) == 4


@pytest.mark.parametrize('across', [False, True])
def test_scan_trainer_captured_over_a_grouped_store(cuda, across):
  """A captured ScanTrainer whose features are a grouped full split (one
  card named three times, 2000 rows padded to 2001, or every card)
  against the same captured trainer over one table, from one start, for
  three epochs of 4 steps of 48 seeds in chunks of 3: each step one
  sharded launch in place of K1's (the replays counted), every other
  count equal; a step's collated rows bit-equal; losses and parameters
  within rtol 1e-4 (the backward's scatter atomics sum in no fixed
  order); the third epoch (replays only) makes no host sync."""
  from graphlearn_tpu_torch.models import train
  torch.backends.cuda.matmul.allow_tf32 = False
  devices = _group(cuda, across)
  fanouts, b = [5, 4], 48
  no, eo = train.tree_hop_offsets(b, fanouts)
  runs = {}
  for name, group in (('one', None), ('group', devices)):
    ds, feats, perm = _grouped_dataset(cuda, 13, group)
    loader = gtt.loader.NeighborLoader(ds, fanouts, perm[:3 * b + 20],
                                       batch_size=b, shuffle=True, seed=3,
                                       dedup='tree', device=cuda)
    model = gtt.models.GraphSAGE(
        16, 32, 5, num_layers=2, hop_node_offsets=no, hop_edge_offsets=eo,
        tree_dense=True, fanouts=fanouts, device=cuda,
        generator=torch.Generator().manual_seed(0))
    t = gtt.loader.ScanTrainer(loader, model, 5, chunk_size=3,
                               capture=True)
    assert t.capture
    runs[name] = [t, train.create_train_state(model), None]
  for epoch in range(3):
    counts = {}
    for name, run in runs.items():
      t, st, _ = run
      ops.reset_launch_counts()
      torch.cuda.synchronize()
      if name == 'group' and epoch == 2:
        torch.cuda.set_sync_debug_mode('error')
      try:
        st, losses, _ = t.run_epoch(st)
      finally:
        torch.cuda.set_sync_debug_mode('default')
      torch.cuda.synchronize()
      run[1], run[2] = st, losses
      counts[name] = ops.launch_counts()
    one, grp = counts['one'], counts['group']
    assert grp['gather_rows_sharded'] == one['gather_rows'] == 4, grp
    assert grp['gather_rows'] == one['gather_rows_sharded'] == 0
    assert {k: v for k, v in grp.items()
            if k not in ('gather_rows', 'gather_rows_sharded')} == \
        {k: v for k, v in one.items()
         if k not in ('gather_rows', 'gather_rows_sharded')}
    torch.testing.assert_close(runs['group'][2], runs['one'][2], rtol=1e-4,
                               atol=0)
  tg, to = runs['group'][0], runs['one'][0]
  assert sorted(tg._graphs) == [1, 3]
  seeds, masks = tg._epoch_seeds(gtt.random.fold_in(tg._perm_key, 0), 4)
  keys = gtt.random.step_keys_plain(
      tg._sampler._key, torch.arange(1, 2, dtype=torch.int64), 2)[0]
  rows = [t._sample_collate(seeds[0], masks[0], keys.to(seeds.device))[0]
          ['x'] for t in (tg, to)]
  assert torch.equal(rows[0], rows[1])
  for a, b in zip(tg.model.parameters(), to.model.parameters()):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)

def _nccl_dist_scan(cuda, shape):
  """Over a world-size-1 NCCL group (``init_multihost``; ``shape`` its
  2-axis layout or None): a captured and an eager ``DistScanTrainer``
  over the group's mesh and a captured one over the one-process mesh at
  P = 1, from one start; 5 steps of 32 seeds (the last ragged) in chunks
  of 2. Returns ``{name: (trainer, state)}`` and the group's teardown."""
  import torch.distributed as dist

  from graphlearn_tpu_torch import distributed as gdist
  from graphlearn_tpu_torch.examples import dist_train_sage_supervised as ex
  torch.backends.cuda.matmul.allow_tf32 = False
  cs = _chip_smoke()
  n, b = 4000, 32
  ei, feats, labels = cs.make_graph(n, 10)
  pb = np.zeros(n, dtype=np.int32)
  parts, fparts = ex.partition_in_memory(ei, feats, pb, 1)
  pool = np.random.default_rng(2).permutation(n)[:4 * b + 20]
  ctx = gdist.init_multihost(f'localhost:{gtt.utils.get_free_port()}', 1,
                             0, device=torch.device('cuda', 0),
                             mesh_shape=shape)
  assert dist.get_backend() == 'nccl'

  def trainer(mesh, capture):
    ds = gdist.DistDataset(1, 0, gdist.DistGraph(1, 0, parts, pb),
                           gdist.DistFeature(1, fparts, pb, mesh,
                                             split_ratio=0.1,
                                             bucket_frac=None),
                           node_labels=labels)
    loader = gdist.DistNeighborLoader(ds, [5, 3], pool, batch_size=b,
                                      shuffle=True, drop_last=False, seed=0,
                                      mesh=mesh, dedup='tree',
                                      bucket_frac=None)
    model = ex.make_model(cs.FEAT_DIM, 32, cs.CLASSES, [5, 3], b, cuda,
                          torch.Generator().manual_seed(0))
    return (gtt.loader.DistScanTrainer(loader, model, cs.CLASSES,
                                       chunk_size=2, capture=capture),
            gtt.models.create_train_state(model))

  runs = {'group_captured': trainer(ctx.mesh, None),
          'group_eager': trainer(ctx.mesh, False),
          'one_process': trainer(gdist.ShardMesh(1, cuda, shape=shape),
                                 None)}
  return runs, dist.destroy_process_group


@pytest.mark.parametrize('shape', [None, (1, 1)])
def test_dist_scan_captured_under_nccl_equals_eager_and_one_process(cuda,
                                                                    shape):
  """``DistScanTrainer`` under an NCCL group (capture on by default on a
  card; flat, and the (1, 1) 2-axis layout with its subgroups): three
  epochs, the captured group's losses and parameters bit-equal to the
  eager group's and to the one-process mesh's captured epoch at P = 1;
  the same launches; the third epoch (replays only) makes no host sync
  but its one epoch-end publish."""
  runs, teardown = _nccl_dist_scan(cuda, shape)
  try:
    cap = runs['group_captured'][0]
    assert cap.capture and cap.mesh.group is not None
    assert runs['one_process'][0].capture
    assert not runs['group_eager'][0].capture
    let_through = _publish_let_through(cap.loader)
    states = {k: st for k, (_, st) in runs.items()}
    for epoch in range(3):
      losses, counts = {}, {}
      for name, (t, _) in runs.items():
        ops.reset_launch_counts()
        strict = name == 'group_captured' and epoch == 2
        torch.cuda.synchronize()
        if strict:
          torch.cuda.set_sync_debug_mode('error')
        try:
          states[name], losses[name], _ = t.run_epoch(states[name])
        finally:
          torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
      for name in ('group_eager', 'one_process'):
        assert torch.equal(losses['group_captured'], losses[name]), \
            (epoch, name)
        assert counts[name] == counts['group_captured'], (epoch, name)
      assert counts['group_captured']['sample_hop'] == 2 * 5
      assert counts['group_captured']['gather_rows'] == 3 * 5
      assert counts['group_captured']['dist_step_keys'] == 3
    assert sorted(cap._graphs) == [1, 2]
    assert len(let_through) == 3
    ref = list(cap.model.parameters())
    for name in ('group_eager', 'one_process'):
      for a, b in zip(ref, runs[name][0].model.parameters()):
        assert torch.equal(a, b), name
  finally:
    teardown()
