"""The port's RemoteScanTrainer, on the CPU.

Mirrors ``tests/test_remote_scan.py``. The servers run in this process
(a ``DistServer`` behind an ``RpcServer`` each), the client is the
port's. The contracts:

* **Equal to the per-batch path.** With ``shuffle=False``, one server
  and ``wire_dtype=None`` the chunk-staged epochs' losses, accuracies
  and parameters equal the port's per-batch remote path's (one worker,
  one prefetch slot), tail batch, tail chunk and second epoch included,
  and every seed is acked exactly once an epoch.
* **Against JAX.** From the same converted parameters, the losses and
  accuracies of two epochs are within atol 1e-5 and rtol 1e-4 of JAX's
  ``RemoteScanTrainer`` (one reference run for the module).
* **Degrade to sync.** An armed ``remote.block_fetch`` fault moves the
  fetch to the dispatch thread: the same epoch, ``remote.prefetch_miss``
  counted.
* **Failover by chunk.** A server that dies mid-epoch has its pending
  blocks rebuilt by a survivor: exact seed coverage and the clean
  epoch's losses, shuffled too; with ``failover=False`` the epoch
  raises.
* **Resume.** ``recovery.ChunkCheckpointer`` on the ack hook; a crash
  resumes at a block boundary in a fresh trainer, equal to the
  uninterrupted epoch.
* **Typed streams**: typed seeds select a typed block stream; an RGNN's
  epochs equal the per-batch typed remote path's.
* **bf16 frames**, whose features here are small integers (exact in
  bf16), train the f32 epoch's bits; and the scope refusals.
"""
import copy

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.utils import faults

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

gdist = gtt.distributed
N = 38          # 38 seeds / bs 4: 10 batches, a ragged tail batch of 2
BS = 4
K = 4           # chunks of 4, 4 and a tail chunk of 2
C = 3
FANOUTS = [2, 2]
TOL = dict(atol=1e-5, rtol=1e-4)
HANDLERS = ('create_sampling_producer', 'producer_num_expected',
            'start_new_epoch_sampling', 'fetch_one_sampled_message',
            'destroy_sampling_producer', 'create_block_producer',
            'block_producer_num_batches', 'block_produce', 'block_fetch',
            'destroy_block_producer', 'block_build_log', 'update_tenant',
            'get_dataset_meta', 'heartbeat', 'get_metrics', 'exit')


def counter(name):
  return metrics.snapshot()['counters'].get(name, 0)


def edges(n=N):
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  return np.stack([rows, cols])


def make_dataset(n=N):
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(edges(n), num_nodes=n)
  ds.init_node_features(np.arange(n, dtype=np.float32)[:, None] *
                        np.ones((1, 4), np.float32))
  ds.init_node_labels(np.arange(n) % C)
  return ds


@pytest.fixture
def servers():
  """``start(n_servers, n) -> [DistServer]`` behind their RPC servers in
  this process, the port's client connected to all; torn down after."""
  pairs = []

  def start(count=1, n=N, ds=None):
    for _ in range(count):
      s = gdist.DistServer(make_dataset(n) if ds is None else ds)
      rpc = gdist.RpcServer(handlers={h: getattr(s, h) for h in HANDLERS})
      pairs.append((s, rpc))
    gdist.init_client(count, 1, 0, [(r.host, r.port) for _, r in pairs])
    return [s for s, _ in pairs]

  yield start
  faults.disarm()
  from graphlearn_tpu_torch.distributed import dist_client
  if dist_client._client is not None:
    dist_client._client.close()
    dist_client._client = None
  for s, rpc in pairs:
    s.exit()
    rpc.shutdown()


def model(seed=0):
  return gtt.models.GraphSAGE(4, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(seed))


def trainer(m, seeds=None, ranks=0, wkw=None, **kw):
  opts = gdist.RemoteDistSamplingWorkerOptions(server_rank=ranks,
                                               **(wkw or {}))
  kw.setdefault('batch_size', BS)
  kw.setdefault('chunk_size', K)
  kw.setdefault('seed', 0)
  return gdist.RemoteScanTrainer(
      FANOUTS, np.arange(N) if seeds is None else seeds, m, C,
      worker_options=opts, device='cpu', **kw)


def run(tr, m, epochs=1):
  """``[(losses, accs, sorted acked seeds)]`` per epoch from a fresh
  state."""
  state = ttrain.create_train_state(m)
  out = []
  for _ in range(epochs):
    state, losses, accs = tr.run_epoch(state)
    out.append((losses, accs, sorted(tr.last_epoch_seed_ids.tolist())))
  return out


def same_params(a, b):
  return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                               b.parameters()))


# ------------------------------------------------------ the JAX reference


@pytest.fixture(scope='module')
def jax_reference():
  """JAX's RemoteScanTrainer over a JAX server in this process: its
  initial parameters and two epochs' losses and accuracies."""
  import jax
  from graphlearn_tpu.distributed import dist_client as jclient
  from graphlearn_tpu.distributed.dist_server import DistServer
  from graphlearn_tpu.distributed.rpc import RpcServer
  from graphlearn_tpu.models import GraphSAGE
  from graphlearn_tpu.models import train as jtrain
  ds = glt.data.Dataset()
  ds.init_graph(edges(), graph_mode='CPU', num_nodes=N)
  ds.init_node_features(np.arange(N, dtype=np.float32)[:, None] *
                        np.ones((1, 4), np.float32))
  ds.init_node_labels(np.arange(N) % C)
  s = DistServer(ds)
  rpc = RpcServer(handlers={h: getattr(s, h) for h in HANDLERS
                            if h != 'block_build_log'})
  try:
    jclient.init_client(num_servers=1, num_clients=1, client_rank=0,
                        server_addrs=[(rpc.host, rpc.port)])
    jm = GraphSAGE(hidden_dim=8, out_dim=C, num_layers=2)
    loader = glt.loader.NeighborLoader(ds, FANOUTS, np.arange(N),
                                       batch_size=BS, shuffle=False)
    template = jtrain.batch_to_dict(next(iter(loader)))
    state, tx = jtrain.create_train_state(jm, jax.random.PRNGKey(0),
                                          template)
    params = jax.tree.map(np.asarray, state.params)
    tr = glt.distributed.RemoteScanTrainer(
        FANOUTS, np.arange(N), jm, tx, C, batch_size=BS, chunk_size=K,
        seed=0, worker_options=glt.distributed.
        RemoteDistSamplingWorkerOptions(server_rank=0))
    epochs = []
    for _ in range(2):
      state, losses, accs = tr.run_epoch(state)
      epochs.append((np.asarray(losses), np.asarray(accs)))
    tr.shutdown()
  finally:
    if jclient._client is not None:
      jclient._client.close()
      jclient._client = None
    s.exit()
    rpc.shutdown()
  return params, epochs


def test_losses_match_jax(servers, jax_reference):
  params, jepochs = jax_reference
  servers()
  m = model()
  m.load_state_dict(convert.params_from_flax(params))
  tr = trainer(m)
  try:
    for (losses, accs, cover), (jl, ja) in zip(run(tr, m, 2), jepochs):
      np.testing.assert_allclose(losses.numpy(), jl, **TOL)
      np.testing.assert_allclose(accs.numpy(), ja, **TOL)
      assert cover == list(range(N))
  finally:
    tr.shutdown()


# ------------------------------------------------- the per-batch path


def test_equal_to_the_per_batch_remote_path(servers):
  """Two epochs: losses, accuracies and parameters equal the per-batch
  remote path's; every seed acked once; one upload a chunk."""
  servers()
  ref_model = model()
  m = copy.deepcopy(ref_model)
  opts = gdist.RemoteDistSamplingWorkerOptions(server_rank=0, num_workers=1,
                                               prefetch_size=1)
  loader = gdist.RemoteDistNeighborLoader(FANOUTS, np.arange(N),
                                          batch_size=BS, worker_options=opts,
                                          seed=0, device='cpu')
  state = ttrain.create_train_state(ref_model)
  step, _ = ttrain.make_train_step(ref_model, C)
  ref = []
  try:
    for _ in range(2):
      losses, accs = [], []
      for b in loader:
        state, loss, acc = step(state, ttrain.batch_to_dict(b))
        losses.append(loss)
        accs.append(acc)
      ref.append((torch.stack(losses), torch.stack(accs)))
  finally:
    loader.shutdown()
  tr = trainer(m)
  try:
    assert len(tr) == 10 and tr._block_boundaries() == [0, 4, 8]
    for (losses, accs, cover), (rl, ra) in zip(run(tr, m, 2), ref):
      assert losses.shape == (10,)
      assert torch.equal(losses, rl) and torch.equal(accs, ra)
      assert cover == list(range(N))
      assert tr.uploads == 3 and tr.replays == 0   # eager on the CPU
    assert same_params(ref_model, m)
    timings = tr.chunk_timings()
    assert [t['k'] for t in timings] == [4, 4, 2]
    assert tr._stager.slot_bytes == 2 * tr._layout.nbytes
    assert all(ok for _, ok in tr._stager.refills)
  finally:
    tr.shutdown()


def test_bf16_frames_train_the_same_bits(servers):
  """The features are small integers, exact in bf16: a bf16-wire epoch
  equals the f32 one, at half the feature bytes on the wire."""
  servers()
  m32, m16 = model(), model()
  t32 = trainer(m32)
  t16 = trainer(m16, wkw=dict(block_wire_dtype='bf16'))
  try:
    (l32, a32, _), = run(t32, m32)
    (l16, a16, _), = run(t16, m16)
    assert torch.equal(l16, l32) and torch.equal(a16, a32)
    assert same_params(m32, m16)
    assert t16._layout.keys[0][3] == np.int16
    x32 = dict((n, b) for n, _, _, _, b in t32._layout.keys)['x']
    x16 = dict((n, b) for n, _, _, _, b in t16._layout.keys)['x']
    assert x16 * 2 == x32
  finally:
    t32.shutdown()
    t16.shutdown()


def test_typed_stream_equal_to_the_per_batch_path(servers):
  """Typed seeds ``('user', ids)`` select a typed block stream (a key
  per plan item a batch): an RGNN's two epochs equal the per-batch
  typed remote path's, tail batch and tail chunk included."""
  from test_torch_mp_loader import typed_datasets
  _, ds, _, _ = typed_datasets()
  servers(ds=ds)
  fan = {('user', 'buys', 'item'): [2, 2], ('item', 'rev_buys', 'user'): [2, 2]}
  seeds = np.arange(2, 20)

  def rgnn():
    return gtt.models.RGNN(
        tuple(gtt.typing.reverse_edge_type(et) for et in fan),
        {'user': 3, 'item': 3}, 8, 2, out_ntype='user', device='cpu',
        generator=torch.Generator().manual_seed(3))

  ref_model, m = rgnn(), rgnn()
  opts = gdist.RemoteDistSamplingWorkerOptions(server_rank=0, num_workers=1,
                                               prefetch_size=1)
  loader = gdist.RemoteDistNeighborLoader(fan, ('user', seeds), batch_size=4,
                                          worker_options=opts, seed=0,
                                          device='cpu')
  state = ttrain.create_train_state(ref_model)
  step, _ = ttrain.make_train_step(ref_model, 2)
  ref = []
  try:
    for _ in range(2):
      losses = []
      for b in loader:
        state, loss, _ = step(state, ttrain.batch_to_dict(b))
        losses.append(loss)
      ref.append(torch.stack(losses))
  finally:
    loader.shutdown()
  tr = gdist.RemoteScanTrainer(
      fan, ('user', seeds), m, 2, batch_size=4, chunk_size=2,
      worker_options=gdist.RemoteDistSamplingWorkerOptions(server_rank=0),
      seed=0, device='cpu')
  try:
    assert len(tr) == 5
    for (losses, _, cover), rl in zip(run(tr, m, 2), ref):
      assert torch.equal(losses, rl)
      assert cover == list(range(2, 20))
    assert same_params(ref_model, m)
  finally:
    tr.shutdown()


# ---------------------------------------------------------- degradation


def test_block_fetch_fault_degrades_to_sync(servers):
  servers()
  m_ref, m = model(), model()
  ref = trainer(m_ref)
  tr = trainer(m)
  try:
    (rl, _, _), = run(ref, m_ref)
    misses = counter('remote.prefetch_miss')
    faults.arm('remote.block_fetch', 'raise', times=2)
    (losses, _, cover), = run(tr, m)
    faults.disarm()
    assert torch.equal(losses, rl) and cover == list(range(N))
    assert counter('remote.prefetch_miss') == misses + 2
    assert tr._stager.degraded
    assert same_params(m_ref, m)
  finally:
    ref.shutdown()
    tr.shutdown()


class _DeadRankClient:
  """The trainer's ``dist_client`` with one rank dead from a given
  moment: every request to it raises ``ConnectionError`` (an in-process
  server's shutdown does not sever pooled connections)."""

  def __init__(self, real, victim):
    self._real, self.victim, self.dead = real, victim, False

  def _check(self, rank):
    if self.dead and rank == self.victim:
      raise ConnectionError(f'rank {rank} is gone')

  def request_server(self, rank, *a, **kw):
    self._check(rank)
    return self._real.request_server(rank, *a, **kw)

  def async_request_server(self, rank, *a, **kw):
    self._check(rank)
    return self._real.async_request_server(rank, *a, **kw)


@pytest.mark.parametrize('shuffle', [False, True])
def test_server_death_fails_over_by_chunk(servers, shuffle):
  """Rank 1 dies right after chunk 0: its pending blocks are rebuilt by
  rank 0 from the same share and seed fold, so the epoch equals the
  healthy two-server epoch with every seed once."""
  servers(2, n=40)
  seeds = np.arange(40)
  m_ref, m = model(), model()
  ref = trainer(m_ref, seeds, ranks=[0, 1], shuffle=shuffle)
  tr = trainer(m, seeds, ranks=[0, 1], shuffle=shuffle,
               wkw=dict(block_ahead=1, heartbeat_interval=60.0))
  shim = _DeadRankClient(tr._dist_client, victim=1)
  tr._dist_client = shim
  fo = counter('remote.failover_blocks')

  def kill(c, start, k):
    if c == 0:
      shim.dead = True

  tr.ack_hook = kill
  try:
    (rl, _, _), = run(ref, m_ref)
    (losses, _, cover), = run(tr, m)
    assert cover == list(range(40))
    assert torch.equal(losses, rl)
    assert same_params(m_ref, m)
    assert 1 in tr._dead_ranks
    assert counter('remote.failover_blocks') > fo
    assert set(d['rank'] for d in tr._schedule) == {0}
  finally:
    ref.shutdown()
    tr.ack_hook = None
    tr.shutdown()


def test_failover_disabled_raises(servers):
  servers(2, n=40)
  m = model()
  tr = trainer(m, np.arange(40), ranks=[0, 1],
               wkw=dict(block_ahead=1, failover=False,
                        heartbeat_interval=60.0))
  shim = _DeadRankClient(tr._dist_client, victim=1)
  tr._dist_client = shim
  shim.dead = True
  try:
    with pytest.raises(RuntimeError, match='failover is disabled'):
      run(tr, m)
    assert 1 not in tr._dead_ranks
  finally:
    shim.dead = False
    tr.shutdown()


def test_set_block_ranks_repoints_pending_blocks(servers):
  """A policy shrink (the elastic path failover shares): rank 1's
  pending blocks move to a replay producer on rank 0, same epoch."""
  servers(2, n=40)
  seeds = np.arange(40)
  m_ref, m = model(), model()
  ref = trainer(m_ref, seeds, ranks=[0, 1])
  tr = trainer(m, seeds, ranks=[0, 1], wkw=dict(block_ahead=1))
  moved = counter('tenant.rebalanced_blocks')
  tr.ack_hook = lambda c, s, k: c == 0 and tr.set_block_ranks([0])
  try:
    (rl, _, _), = run(ref, m_ref)
    (losses, _, cover), = run(tr, m)
    assert torch.equal(losses, rl) and cover == list(range(40))
    assert counter('tenant.rebalanced_blocks') > moved
    with pytest.raises(ValueError, match='unknown server ranks'):
      tr.set_block_ranks([7])
  finally:
    ref.shutdown()
    tr.shutdown()


# -------------------------------------------------------------- resume


def test_crash_resumes_at_a_block_boundary(servers, tmp_path):
  from graphlearn_tpu_torch.recovery import ChunkCheckpointer
  servers()
  m_ref, m = model(), model()
  ref = trainer(m_ref)
  (rl, ra, _), = run(ref, m_ref)
  ref.shutdown()
  tr = trainer(m)
  ck = ChunkCheckpointer(str(tmp_path), every=1).attach(tr)

  def crash(c, start, k):
    if c == 2:
      raise RuntimeError('crash at chunk 2')

  tr.stage_hook = crash
  with pytest.raises(RuntimeError, match='crash at chunk 2'):
    tr.run_epoch(ttrain.create_train_state(m))
  ck.flush()
  tr.shutdown()
  m2 = model(seed=5)      # any start: the snapshot restores the state
  fresh = trainer(m2)
  try:
    with pytest.raises(ValueError, match='block boundary'):
      fresh.run_epoch(ttrain.create_train_state(m2), start_step=3)
    state, losses, accs = ChunkCheckpointer(str(tmp_path)).resume_epoch(
        fresh, ttrain.create_train_state(m2))
    np.testing.assert_array_equal(np.asarray(losses), rl.numpy())
    np.testing.assert_array_equal(np.asarray(accs), ra.numpy())
    assert same_params(m_ref, m2) and state.step == 10
    assert fresh._epochs == 1
  finally:
    fresh.shutdown()


# --------------------------------------------------------------- scope


def test_scope_messages(servers):
  servers()
  m = model()
  with pytest.raises(ValueError, match='collect_features=True'):
    trainer(m, collect_features=False)
  with pytest.raises(ValueError, match='capture=True needs a CUDA'):
    trainer(m, capture=True)
  with pytest.raises(ValueError, match='chunk_size must be >= 1'):
    trainer(m, chunk_size=0)
  tr = trainer(m)
  try:
    with pytest.raises(ValueError, match='outside this epoch'):
      tr.run_epoch(ttrain.create_train_state(m), max_steps=4, start_step=4)
    state, losses, _ = tr.run_epoch(ttrain.create_train_state(m),
                                    max_steps=0)
    assert losses.shape == (0,) and state.step == 0
    with pytest.raises(ValueError, match='max_ahead'):
      gdist.RemoteBlockStager(lambda c: {}, max_ahead=0)
  finally:
    tr.shutdown()


def test_stager_slot_released_after_a_failed_pack():
  """A frame whose packing fails degrades its chunk to the synchronous
  fetch, and its slot still goes back at the ack: the next chunk of that
  slot is packed by the worker, not left to time out."""
  frames = {c: dict(v=np.full(4, c, np.float32)) for c in range(3)}
  failed = []

  def pack(frame, buf):
    if not failed:
      failed.append(True)
      raise RuntimeError('pack failed')
    buf.numpy().view(np.float32)[:4] = frame['v']
    return {}

  stager = gdist.RemoteBlockStager(frames.__getitem__, max_ahead=1,
                                   timeout_s=5.0, pack_fn=pack,
                                   slot_bytes_fn=lambda f: 16)
  misses = counter('remote.prefetch_miss')
  try:
    stager.begin_epoch(3)
    slab = stager.take(0)
    assert slab.slot is None and slab.frame is frames[0]
    assert counter('remote.prefetch_miss') == misses + 1
    stager.ack(0)
    for c in (1, 2):
      slab = stager.take(c)
      assert slab.slot is not None
      assert (slab.slot.buf.numpy().view(np.float32) == c).all()
      stager.ack(c)
    assert counter('remote.prefetch_miss') == misses + 1
    assert [c for c, _ in stager.refills] == [0, 1, 2]
  finally:
    stager.close()
