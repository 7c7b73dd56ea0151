"""The port's channels against the JAX package's, on the CPU.

Mirrors ``tests/test_channel.py`` (the message serializer, the
shared-memory ring: round trip, timeout, end-of-stream, a producer in
another process; the multiprocessing channel; the remote channel's
end-of-epoch and restart protocol), then holds the wire format
byte-compatible both ways with JAX's, the ring's C++ source byte-equal
to the JAX package's, the ring's size limit and the loader of its
library (no fallback), and the messages the port builds from its
sampler's batches equal to those JAX builds from its own at the same
key. Every test leaves no ring open (``live_channel_count``).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.channel import base as jbase
from graphlearn_tpu_torch.channel import (MpChannel, QueueTimeoutError,
                                          ShmChannel, deserialize_message,
                                          live_channel_count,
                                          serialize_message)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_ring_left():
  base = live_channel_count()
  yield
  assert live_channel_count() == base


def sample_msg():
  return {
      'node': np.arange(10, dtype=np.int64),
      'x': np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32),
      '#META.bs': np.array([4], dtype=np.int32),
      'scalarish': np.array(7, dtype=np.int64),
      'mask': np.array([True, False, True]),
      'empty': np.zeros((0, 3), np.float32),
  }


def assert_msg_equal(a, b, wire=True):
  assert set(a.keys()) == set(b.keys())
  for k in a:
    np.testing.assert_array_equal(a[k], b[k])
    assert a[k].dtype == b[k].dtype
    # a 0-d array rides the serialized wire as [1], in both packages
    want = np.ascontiguousarray(a[k]) if wire else a[k]
    assert want.shape == b[k].shape


def test_serializer_roundtrip():
  msg = sample_msg()
  assert_msg_equal(msg, deserialize_message(serialize_message(msg)))


def test_messages_byte_compatible_both_ways():
  msg = sample_msg()
  ours, theirs = serialize_message(msg), jbase.serialize_message(msg)
  assert isinstance(ours, bytes) and ours == theirs
  assert_msg_equal(msg, deserialize_message(theirs))
  assert_msg_equal(msg, jbase.deserialize_message(ours))
  with pytest.raises(ValueError, match='corrupt'):
    deserialize_message(b'\x00' * 8)


def test_shm_channel_roundtrip():
  ch = ShmChannel(shm_size=1 << 20)
  try:
    msg = sample_msg()
    ch.send(msg)
    ch.send(msg)
    assert_msg_equal(msg, ch.recv(timeout_ms=1000))
    assert_msg_equal(msg, ch.recv(timeout_ms=1000))
    assert ch.empty()
  finally:
    ch.close()


def test_shm_channel_timeout():
  ch = ShmChannel(shm_size=1 << 16)
  try:
    t0 = time.monotonic()
    with pytest.raises(QueueTimeoutError):
      ch.recv(timeout_ms=200)
    assert time.monotonic() - t0 >= 0.15
  finally:
    ch.close()


def test_shm_channel_finish():
  ch = ShmChannel(shm_size=1 << 16)
  try:
    ch.finish()
    with pytest.raises(StopIteration):
      ch.recv(timeout_ms=1000)
    ch.reset()
    ch.send({'a': np.arange(3)})
    assert_msg_equal({'a': np.arange(3)}, ch.recv(timeout_ms=1000))
  finally:
    ch.close()


def test_message_larger_than_the_ring_raises():
  ch = ShmChannel(shm_size=1 << 12)
  try:
    with pytest.raises(RuntimeError, match='exceeds ring capacity'):
      ch.send({'a': np.zeros(1 << 12, np.uint8)})
    assert ch.empty()
  finally:
    ch.close()


_PRODUCER = """
import pickle, sys
import numpy as np
ch = pickle.loads(bytes.fromhex(sys.argv[1]))
for i in range(5):
  ch.send({'i': np.array([i]), 'payload': np.full((100,), i)})
ch.finish()
ch.close()
"""


def test_shm_channel_cross_process():
  """A producer in another process attaches to the ring by its pickled
  shmid and sends five messages, then the end-of-stream mark."""
  import pickle
  import subprocess
  import sys
  ch = ShmChannel(shm_size=1 << 20)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.Popen([sys.executable, '-c', _PRODUCER,
                           pickle.dumps(ch).hex()], env=env)
  try:
    got = []
    while True:
      try:
        msg = ch.recv(timeout_ms=60000)
      except StopIteration:
        break
      got.append(int(msg['i'][0]))
      np.testing.assert_array_equal(msg['payload'],
                                    np.full((100,), got[-1]))
    assert proc.wait(timeout=30) == 0
    assert got == list(range(5))
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait(10)
    ch.close()


def test_mp_channel():
  ch = MpChannel(capacity=4)
  msg = sample_msg()
  ch.send(msg)
  assert_msg_equal(msg, ch.recv(timeout_ms=1000), wire=False)
  with pytest.raises(QueueTimeoutError):
    ch.recv(timeout_ms=100)


def _below_header(path):
  """The source from its first line that is not a leading comment."""
  lines = open(path, 'rb').read().splitlines(keepends=True)
  i = 0
  while i < len(lines) and (lines[i].startswith(b'//') or
                            not lines[i].strip()):
    i += 1
  return b''.join(lines[i:])


def test_shm_ring_source_is_the_jax_packages():
  """The port's ring is the JAX package's below the header comment, byte
  for byte, so a fix to one cannot miss the other."""
  ours = _below_header(os.path.join(ROOT, 'graphlearn_tpu_torch', 'csrc',
                                    'shm_queue.cc'))
  assert ours == _below_header(os.path.join(ROOT, 'csrc', 'shm_queue.cc'))
  assert b'shmq_create' in ours and len(ours) > 5000


def test_native_build_has_no_fallback(monkeypatch, tmp_path):
  from graphlearn_tpu_torch.utils import build
  assert os.path.exists(build.build_native())
  bad = tmp_path / 'bad.cc'
  bad.write_text('this is not C++\n')
  monkeypatch.setattr(build, '_SRC', bad)
  monkeypatch.setattr(build, '_BUILD', tmp_path / 'out')
  with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
    build.build_native()
  monkeypatch.setattr(build.shutil, 'which', lambda name: None)
  with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
    build.build_native(force=True)
  assert not list((tmp_path / 'out').glob('*.so'))


class _FakeServer:
  """In-process stand-in for DistServer's fetch contract: one epoch =
  ``total`` messages then (None, True); restartable."""

  def __init__(self, total):
    self.total = total
    self.served = 0
    self.lock = threading.Lock()

  def fetch(self, rank, pid):
    with self.lock:
      i = self.served
      if i >= self.total:
        return None, True
      self.served += 1
    if i == self.total - 1:
      time.sleep(0.15)  # straggler: last message delayed past end response
    return {'i': np.array([i])}, False

  def restart(self):
    with self.lock:
      self.served = 0


def _drain(ch):
  got = []
  while True:
    try:
      got.append(int(ch.recv(timeout_ms=5000)['i'][0]))
    except StopIteration:
      return got


def test_remote_channel_no_straggler_drop():
  """prefetch > 1: the delayed final message is not lost behind the end
  marker (the marker is enqueued by the last puller only)."""
  from graphlearn_tpu_torch.channel import RemoteReceivingChannel
  srv = _FakeServer(7)
  ch = RemoteReceivingChannel([0], [0], prefetch_size=4,
                              request_fn=srv.fetch)
  try:
    assert sorted(_drain(ch)) == list(range(7))
  finally:
    ch.stop(join=True)


def test_remote_channel_abandoned_epoch_restart():
  """Abandoning an epoch mid-stream then starting a new one loses and
  duplicates no new-epoch message (stale pullers joined in start())."""
  from graphlearn_tpu_torch.channel import RemoteReceivingChannel
  srv = _FakeServer(6)
  ch = RemoteReceivingChannel([0], [0], prefetch_size=3,
                              request_fn=srv.fetch)
  try:
    ch.start()
    first = int(ch.recv(timeout_ms=5000)['i'][0])  # consume one, abandon
    assert first in range(6)
    ch.stop(join=True)
    srv.restart()
    ch.start()
    got = _drain(ch)
    assert sorted(set(got)) == sorted(got), 'duplicates in epoch'
    assert len(got) == 6, got
  finally:
    ch.stop(join=True)


# ----------------------------------------- messages of sampled batches


N = 60


def _graphs():
  rng = np.random.default_rng(5)
  ei = np.stack([rng.integers(0, N, 240), rng.integers(0, N, 240)])
  feat = rng.standard_normal((N, 3)).astype(np.float32)
  labels = np.arange(N) % 4
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feat)
  ds.init_node_labels(labels)
  return jds, ds, feat, labels


@pytest.mark.parametrize('with_edge', [False, True])
def test_batch_messages_equal_jax(with_edge):
  """The port's message of a batch equals the one JAX's worker builds from
  its own sampler at the same key (keys, arrays, dtypes), and
  ``message_to_data`` of either gives the same batch on the port."""
  from graphlearn_tpu.distributed import message as jmsg
  from graphlearn_tpu_torch.distributed import message as tmsg
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  jds, ds, feat, labels = _graphs()
  seeds = np.array([3, 17, 40, 59, 8])
  js = glt.sampler.NeighborSampler(jds.graph, [3, 2], seed=11,
                                   with_edge=with_edge)
  ts = gtt.sampler.NeighborSampler(ds.graph, [3, 2], device='cpu',
                                   seed=11, with_edge=with_edge)
  jout = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds),
                              batch_cap=8)
  tout = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds),
                              batch_cap=8)
  node = np.asarray(jout.node)
  jm = jmsg.output_to_message(jout, feat[np.maximum(node, 0)],
                              labels[np.clip(node, 0, N - 1)])
  tm = tmsg.output_to_message(tout, *_batch_message(ds, tout, True, False))
  assert set(tm) == set(jm)
  for k in jm:
    np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    assert tm[k].shape == jm[k].shape, k
  # through the wire and back, from either side's bytes
  for m in (tm, deserialize_message(jbase.serialize_message(jm))):
    b = tmsg.message_to_data(m, device='cpu')
    np.testing.assert_array_equal(b.node.numpy(), node)
    np.testing.assert_array_equal(b.x.numpy(), feat[np.maximum(node, 0)])
    assert b.num_nodes == int(jout.num_nodes)
    assert b.batch_size == 5
    np.testing.assert_array_equal(b.edge_index.numpy(),
                                  np.stack([jout.row, jout.col]))
    np.testing.assert_array_equal(
        b.node_mask.numpy(), np.arange(node.shape[0]) < int(jout.num_nodes))
  nb = tmsg.message_to_data(tm, to_device=False)
  assert isinstance(nb.node, np.ndarray)


def test_typed_batch_messages_equal_jax():
  from graphlearn_tpu.distributed import message as jmsg
  from graphlearn_tpu_torch.distributed import message as tmsg
  from graphlearn_tpu_torch.distributed.dist_sampling_producer import \
      _batch_message
  ub = np.array([[0, 0, 1, 2, 2, 3, 4, 5], [0, 1, 2, 3, 0, 1, 2, 3]])
  UB, BU = ('user', 'buys', 'item'), ('item', 'rev_buys', 'user')
  feats = {'user': np.arange(18, dtype=np.float32).reshape(6, 3),
           'item': 100 + np.arange(12, dtype=np.float32).reshape(4, 3)}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph({UB: ub, BU: ub[::-1].copy()}, graph_mode='CPU',
                 num_nodes={UB: 6, BU: 4})
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph({UB: ub, BU: ub[::-1].copy()}, num_nodes={UB: 6, BU: 4})
  ds.init_node_features(feats)
  ds.init_node_labels({'user': np.arange(6) % 2})
  fan = {UB: [2, 2], BU: [2, 2]}
  js = glt.sampler.NeighborSampler(jds.graph, fan, seed=3)
  ts = gtt.sampler.NeighborSampler(ds.graph, fan, device='cpu', seed=3)
  inp = ('user', np.array([0, 2, 5]))
  jout = js.sample_from_nodes(glt.sampler.NodeSamplerInput(inp[1], 'user'),
                              batch_cap=4)
  tout = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(inp[1], 'user'),
                              batch_cap=4)
  x_d = {t: feats[t][np.maximum(np.asarray(v), 0)]
         for t, v in jout.node.items()}
  y_d = {'user': (np.arange(6) % 2)[np.clip(np.asarray(jout.node['user']),
                                            0, 5)]}
  jm = jmsg.hetero_output_to_message(jout, x_d, y_d)
  tm = tmsg.hetero_output_to_message(
      tout, *_batch_message(ds, tout, True, True))
  assert set(tm) == set(jm)
  for k in jm:
    np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
  b = tmsg.message_to_data(tm, device='cpu')
  assert b.metadata['input_type'] == 'user' and b.batch_size == 3
  for et, ei in b.edge_index.items():
    np.testing.assert_array_equal(
        ei.numpy(), np.stack([jout.row[et], jout.col[et]]))
