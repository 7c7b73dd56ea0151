"""The port's RPC, server and remote loaders against the JAX package's,
on the CPU.

Mirrors ``tests/test_server_client.py`` (the RPC round trip, the mutual
HMAC handshake and an imposter server, the server-client end to end) and
holds the wire interoperable: a port client completes the handshake
against a JAX ``RpcServer`` and a JAX client against a port one, a
wrong secret refused on both sides. The ``DistServer`` runs in the
test's own process (its RPC threads), its producers' workers in spawned
processes; each remote batch (homogeneous, typed, link) is held against
JAX's in-process sampler at the worker seed JAX's server would give it
(the server fold ``seed * 7919 + i``, then ``* 1000003 + rank``).
"""
import socket
import threading

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.channel import live_channel_count
from test_torch_mp_loader import (BU, UB, assert_homo_batch,
                                  assert_typed_batch, datasets,
                                  jax_worker_batches, key_node_batch,
                                  typed_datasets)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

gdist = gtt.distributed
N = 40


@pytest.fixture(autouse=True)
def no_ring_left():
  base = live_channel_count()
  yield
  assert live_channel_count() == base


@pytest.fixture
def server():
  """``start(dataset) -> (host, port)``: a ``DistServer`` in this
  process; the client is connected, and both are shut down after."""
  started = []

  def start(ds, **kw):
    host, port = gdist.init_server(1, 1, 0, ds, **kw)
    gdist.init_client(1, 1, 0, [(host, port)])
    started.append(True)
    return host, port

  yield start
  if started:
    gdist.shutdown_client()
    gdist.wait_and_shutdown_server(timeout=30)
    assert gdist.get_server() is None


def test_rpc_roundtrip():
  server = gdist.RpcServer()
  server.register('add', lambda a, b: a + b)
  server.register('echo_array', lambda x: x * 2)
  client = gdist.RpcClient()
  client.add_target(0, server.host, server.port)
  try:
    assert client.request_sync(0, 'add', 2, 3) == 5
    arr = np.arange(5)
    np.testing.assert_array_equal(client.request_sync(0, 'echo_array', arr),
                                  arr * 2)
    futs = [client.request_async(0, 'add', i, i) for i in range(8)]
    assert [f.result() for f in futs] == [2 * i for i in range(8)]
    with pytest.raises(RuntimeError, match='remote error'):
      client.request_sync(0, 'add', 'x', 1)
  finally:
    client.close()
    server.shutdown()


def test_rpc_hmac_handshake(monkeypatch):
  """Authenticated clients round-trip; unauthenticated and wrong-secret
  clients never reach the deserializer; a routable bind without a
  secret refuses to start."""
  server = gdist.RpcServer(secret=b'sesame')
  server.register('add', lambda a, b: a + b)
  calls = []
  server.register('probe', lambda: calls.append(1))
  try:
    good = gdist.RpcClient(secret=b'sesame')
    good.add_target(0, server.host, server.port)
    assert good.request_sync(0, 'add', 2, 3) == 5
    good.close()
    for secret in (None, b'wrong'):
      bad = gdist.RpcClient(secret=secret)
      bad.add_target(0, server.host, server.port)
      with pytest.raises((ConnectionError, TimeoutError, RuntimeError)):
        bad.request_sync(0, 'probe', timeout=2.0)
      bad.close()
    assert not calls
  finally:
    server.shutdown()
  monkeypatch.delenv('GLT_RPC_SECRET', raising=False)
  with pytest.raises(ValueError, match='routable'):
    gdist.RpcServer(host='0.0.0.0')


def test_rpc_mutual_handshake_rejects_imposter_server():
  """A server that does not know the secret, or reflects the client's
  own answer, is dropped before any response frame is unpickled."""
  from graphlearn_tpu_torch.distributed.rpc import _hmac_of

  def run_fake_server(make_proof, holder, ready):
    ls = socket.socket()
    ls.bind(('127.0.0.1', 0))
    ls.listen(1)
    ls.settimeout(10)
    holder.append(ls.getsockname()[1])
    ready.set()
    conn, _ = ls.accept()
    conn.settimeout(10)
    conn.sendall(b'N' * 32)
    answer = b''
    while len(answer) < 64:
      answer += conn.recv(64 - len(answer))
    conn.sendall(make_proof(answer))
    try:
      conn.recv(1024)
    except OSError:
      pass
    conn.close()
    ls.close()

  for make_proof in (lambda answer: b'P' * 32,
                     lambda answer: _hmac_of(b'sesame', answer[32:])):
    holder, ready = [], threading.Event()
    t = threading.Thread(target=run_fake_server,
                         args=(make_proof, holder, ready), daemon=True)
    t.start()
    assert ready.wait(5)
    cli = gdist.RpcClient(secret=b'sesame')
    cli.add_target(0, '127.0.0.1', holder[0])
    with pytest.raises((ConnectionError, TimeoutError)):
      cli.request_sync(0, 'add', 1, 1, timeout=5)
    cli.close()
    t.join(10)
    assert not t.is_alive()


@pytest.mark.parametrize('server_pkg,client_pkg', [('jax', 'port'),
                                                   ('port', 'jax')])
def test_rpc_handshake_interoperates_with_jax(server_pkg, client_pkg):
  """The frame format and the HMAC handshake are JAX's byte for byte: a
  client of one package calls a server of the other, arrays and all,
  and a wrong secret is refused either way."""
  mods = {'jax': glt.distributed, 'port': gdist}
  server = mods[server_pkg].RpcServer(secret=b'sesame')
  server.register('scale', lambda x, k=1: x * k)
  try:
    good = mods[client_pkg].RpcClient(secret=b'sesame')
    good.add_target(0, server.host, server.port)
    np.testing.assert_array_equal(
        good.request_sync(0, 'scale', np.arange(4), k=3), np.arange(4) * 3)
    with pytest.raises(RuntimeError, match='remote error'):
      good.request_sync(0, 'missing')
    good.close()
    wrong = mods[client_pkg].RpcClient(secret=b'wrong')
    wrong.add_target(0, server.host, server.port)
    with pytest.raises((ConnectionError, TimeoutError)):
      wrong.request_sync(0, 'scale', 1, timeout=3.0)
    wrong.close()
  finally:
    server.shutdown()


def _remote_node_batches(loader, seeds, W, bs, epochs):
  """{(epoch, worker, batch index): batch} of a one-server loader with
  ``W`` workers (shuffle off: the worker's share in order)."""
  splits = np.array_split(np.arange(seeds.shape[0]), W)
  orders = [np.arange(s.shape[0]) for s in splits]
  out = {}
  for epoch in range(epochs):
    seen = []
    for b in loader:
      bn = b.batch if not isinstance(b.batch, dict) else \
          b.batch[b.metadata['input_type']]
      ids = bn.numpy()[:b.batch_size]
      seen.extend(ids.tolist())
      w, j = key_node_batch(ids, seeds, splits, orders, bs)
      out[(epoch, w, j)] = b
    assert sorted(seen) == sorted(seeds.tolist())
  return out, splits


def test_server_client_end_to_end(server):
  """Two epochs of ``RemoteDistNeighborLoader`` from a server with two
  workers: every batch equals JAX's sampler at the worker seed; the
  metadata RPC, the server's metrics (its own launch counts and its
  producers' workers') and the serving RPC answer."""
  jds, ds, feat, labels = datasets()
  server(ds)
  meta = gdist.request_server(0, 'get_dataset_meta')
  assert meta['num_nodes'] == N and meta['edge_dir'] == 'out'
  opts = gdist.RemoteDistSamplingWorkerOptions(
      server_rank=0, num_workers=2, prefetch_size=2)
  seeds, bs = np.arange(N), 4
  loader = gdist.RemoteDistNeighborLoader(
      [3, 2], seeds, batch_size=bs, collect_features=True,
      worker_options=opts, seed=0, device='cpu')
  try:
    assert len(loader) == 10
    got, splits = _remote_node_batches(loader, seeds, 2, bs, 2)
    assert len(got) == 20
    for w, s in enumerate(splits):
      blks = seeds[s]
      inputs = [(glt.sampler.NodeSamplerInput(blks[i:i + bs]), bs)
                for i in range(0, blks.shape[0], bs)]
      # the server folds its index into the seed: 0 * 7919 + 0
      want = jax_worker_batches(jds, [3, 2], 0, w, inputs + inputs)
      n = len(inputs)
      for k, jout in enumerate(want):
        assert_homo_batch(got[(k // n, w, k % n)], jout, feat, labels)
    m = gdist.request_server(0, 'get_metrics', idempotent=True)
    assert set(m['server']['launches']) == set(gtt.ops.launch_counts())
    (pm,) = m['producers'].values()
    assert pm['workers'] == [0, 1] and 'launches' in pm
    assert pm['counters']['producer.batches'] == 20
  finally:
    loader.shutdown()
  # the serve RPC goes through a registered engine's admission queue
  table = np.random.default_rng(2).standard_normal((N, 5)).astype(np.float32)
  store = gtt.serving.EmbeddingStore(table, device='cpu')
  with gtt.serving.ServingEngine(store, buckets=(8, 32)) as engine:
    gdist.get_server().register_serving_engine(engine)
    ids = np.array([3, 39, 0, 7, 7])
    np.testing.assert_array_equal(
        gdist.request_server(0, 'serve', ids, idempotent=True), table[ids])


def test_server_client_hetero_end_to_end(server):
  """Typed seeds through the server: ('user', ids) ride a
  NodeSamplerInput and typed batches come back."""
  jds, ds, feats, _ = typed_datasets()
  server(ds)
  meta = gdist.request_server(0, 'get_dataset_meta')
  assert meta['edge_dir'] == 'out' and UB in meta['edge_types']
  fan = {UB: [3, 2], BU: [2, 2]}
  seeds, bs = np.arange(10), 2
  opts = gdist.RemoteDistSamplingWorkerOptions(
      server_rank=0, num_workers=2, prefetch_size=2)
  loader = gdist.RemoteDistNeighborLoader(
      fan, ('user', seeds), batch_size=bs, worker_options=opts, seed=0,
      device='cpu')
  try:
    got, splits = _remote_node_batches(loader, seeds, 2, bs, 1)
    for w, s in enumerate(splits):
      blks = seeds[s]
      want = jax_worker_batches(jds, fan, 0, w, [
          (glt.sampler.NodeSamplerInput(blks[i:i + bs], 'user'), bs)
          for i in range(0, blks.shape[0], bs)])
      for j, jout in enumerate(want):
        assert_typed_batch(got[(0, w, j)], jout, feats,
                           {'user': np.arange(30) % 2})
  finally:
    loader.shutdown()


def test_server_client_link_end_to_end(server):
  """Link batches from the server, negatives drawn there, equal JAX's
  link engine at the worker seed (one worker: in order)."""
  from graphlearn_tpu.sampler import EdgeSamplerInput as JESI
  from graphlearn_tpu.sampler import NegativeSampling as JNS
  jds, ds, feat, labels = datasets()
  server(ds)
  rows, cols = np.arange(N), (np.arange(N) + 1) % N
  bs = 8
  opts = gdist.RemoteDistSamplingWorkerOptions(
      server_rank=0, num_workers=1, prefetch_size=1)
  loader = gdist.RemoteDistLinkNeighborLoader(
      [3], np.stack([rows, cols]),
      neg_sampling=gtt.sampler.NegativeSampling('binary', 1),
      batch_size=bs, worker_options=opts, seed=2, device='cpu')
  try:
    got = list(loader)
    assert len(got) == len(loader) == 5
    want = jax_worker_batches(jds, [3], 2 * 7919, 0, [
        (JESI(rows[i:i + bs], cols[i:i + bs],
              neg_sampling=JNS('binary', 1)), None)
        for i in range(0, N, bs)])
    for b, jout in zip(got, want):
      node = np.asarray(jout.node)
      np.testing.assert_array_equal(b.node.numpy(), node)
      np.testing.assert_array_equal(b.edge_index.numpy(),
                                    np.stack([jout.row, jout.col]))
      np.testing.assert_array_equal(b.x.numpy(), feat[np.maximum(node, 0)])
      for k in ('edge_label_index', 'edge_label'):
        np.testing.assert_array_equal(np.asarray(b.metadata[k]),
                                      np.asarray(jout.metadata[k]))
      eli = np.asarray(b.metadata['edge_label_index'])
      label = np.asarray(b.metadata['edge_label'])
      for i in np.nonzero(label == 1)[0]:
        assert int(node[eli[1, i]]) == (int(node[eli[0, i]]) + 1) % N
  finally:
    loader.shutdown()


def test_next_slice_names_are_refused(server):
  """What the remote-scan slice brought is no longer refused: a server
  with ``tenancy=``, the block producers' RPCs over the wire and a
  remote loader's ``tenant=`` are served (``test_torch_tenancy.py`` and
  ``test_torch_remote_scan.py`` hold them against JAX)."""
  from graphlearn_tpu_torch.sampler import SamplingConfig, SamplingType
  _, ds, feat, _ = datasets()
  assert gdist.DistServer(ds, tenancy=gdist.TenancyConfig()).exit()
  server(ds, tenancy=gdist.TenancyConfig())
  cfg = SamplingConfig(SamplingType.NODE, [2], 4, False, False, False,
                       True, False, False, 'out', 0)
  pid = gdist.request_server(0, 'create_block_producer', np.arange(8), cfg,
                             None)
  assert gdist.request_server(0, 'block_producer_num_batches', pid) == 2
  frame = gdist.request_server(0, 'block_fetch', pid, 0, 0, 1)
  assert frame['x'].shape[0] == 1 and int(frame['#META.num_batches']) == 1
  np.testing.assert_array_equal(
      frame['x'][0], feat[np.maximum(frame['node'][0], 0)])
  assert gdist.request_server(0, 'destroy_block_producer', pid)
  opts = gdist.RemoteDistSamplingWorkerOptions(server_rank=0,
                                               tenant='interactive')
  loader = gdist.RemoteDistNeighborLoader([2], np.arange(8),
                                          worker_options=opts,
                                          device='cpu')
  try:
    assert sum(1 for _ in loader) == len(loader) == 1
  finally:
    loader.shutdown()


@pytest.mark.parametrize('seed', [0, 7, 2 ** 32, 2 * 7919 * 1000003 + 1,
                                  -5, 2 ** 62 + 3])
def test_prng_key_of_folded_seeds_is_jax_s(seed):
  """The remote folds (``seed * 7919 + i``, ``* 1000003 + rank``) outgrow
  32 bits; the port's key is JAX's for them too."""
  import jax
  np.testing.assert_array_equal(
      gtt.random.PRNGKey(seed).numpy(),
      np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


def test_server_loads_remote_path_seeds(tmp_path):
  """A ``RemoteNodePathSamplerInput`` names a seed file on the server,
  which loads it when the producer is made."""
  _, ds, _, _ = datasets()
  np.save(tmp_path / 'seeds.npy', np.arange(10))
  server = gdist.DistServer(ds)
  try:
    pid = server.create_sampling_producer(
        gtt.sampler.RemoteNodePathSamplerInput(str(tmp_path / 'seeds.npy')),
        gtt.sampler.SamplingConfig(gtt.sampler.SamplingType.NODE, [2], 4))
    assert server.producer_num_expected(pid) == 3
  finally:
    assert server.exit()
