"""The port's block producer against the JAX package's, on the CPU.

Mirrors the frame half of ``tests/test_remote_scan.py``: the same seed
share and ``SamplingConfig`` through JAX's ``BlockSampleProducer`` and
the port's give the same frames, key for key and array for array (dtype,
shape and bytes), for homogeneous node streams (the default merge engine
and the tree engine), a typed node stream, binary and triplet link
streams and a typed binary link stream, each at a shuffled epoch's first
block (batches 0 and 1) and at its tail block. A bf16 frame's features
are the same bits (the port carries them as ``uint16``, JAX as
``ml_dtypes.bfloat16``). ``stack_block_frames``' pow2 ``INT32_MAX``
padding, ``block_mb_per_chunk``, the random-access counter and the
producer's cache (produce, then a pop on fetch) follow. The JAX frames
are built once for the module.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
from graphlearn_tpu.distributed import block_producer as jbp
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.distributed import block_producer as tbp

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N = 40
BS = 4
UB, BU = ('user', 'buys', 'item'), ('item', 'rev_buys', 'user')
NU, NI = 30, 20


def homo_data():
  rng = np.random.default_rng(4)
  ei = np.stack([rng.integers(0, N, N * 6), rng.integers(0, N, N * 6)])
  feat = np.random.default_rng(9).standard_normal((N, 4)).astype(np.float32)
  labels = np.arange(N) % 3
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=N)
  jds.init_node_features(feat)
  jds.init_node_labels(labels)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feat)
  ds.init_node_labels(labels)
  return jds, ds, ei


def typed_data():
  rng = np.random.default_rng(6)
  ub = np.stack([rng.integers(0, NU, 150), rng.integers(0, NI, 150)])
  feats = {'user': rng.standard_normal((NU, 3)).astype(np.float32),
           'item': rng.standard_normal((NI, 3)).astype(np.float32)}
  edges = {UB: ub, BU: ub[::-1].copy()}
  nn = {UB: NU, BU: NI}
  labels = {'user': np.arange(NU) % 2}
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU', num_nodes=nn)
  jds.init_node_features(feats)
  jds.init_node_labels(labels)
  ds = gtt.data.Dataset(edge_dir='out', device='cpu')
  ds.init_graph(edges, num_nodes=nn)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  return jds, ds, ub


def config(mod, kind, fanouts, seed=3, shuffle=True, with_neg=False):
  s = mod.sampler
  return s.SamplingConfig(getattr(s.SamplingType, kind), fanouts, BS,
                          shuffle, False, False, True, with_neg, False,
                          'out', seed)


def link_input(rows, cols, mode, amount=1, etype=None):
  d = dict(rows=rows, cols=cols, label=None, neg_mode=mode,
           neg_amount=amount)
  if etype is not None:
    d['input_type'] = etype
  return d


def _streams():
  """name -> (dataset pair, share maker, kind, fanouts, with_neg, dedup)."""
  homo, typed = homo_data(), typed_data()
  ei, ub = homo[2], typed[2]
  fan_t = {UB: [3, 2], BU: [2, 2]}
  return {
      'node_merge': (homo, np.arange(3, 33), 'NODE', [2, 2], False, None),
      'node_tree': (homo, np.arange(3, 33), 'NODE', [2, 2], False, 'tree'),
      'node_typed': (typed, ('user', np.arange(2, 25)), 'NODE', fan_t,
                     False, None),
      'link_binary': (homo, link_input(ei[0, :22], ei[1, :22], 'binary'),
                      'LINK', [2, 2], True, None),
      'link_triplet': (homo, link_input(ei[0, 5:27], ei[1, 5:27], 'triplet',
                                        2), 'LINK', [2, 2], True, None),
      'link_typed': (typed, link_input(ub[0, :18], ub[1, :18], 'binary',
                                       etype=UB), 'LINK', fan_t, True, None),
  }


STREAMS = sorted(_streams())


def _producer(mod, ds, share, kind, fan, with_neg, dedup, wire_dtype=None):
  bp = jbp if mod is glt else tbp
  p = bp.BlockSampleProducer(ds, share, config(mod, kind, fan,
                                               with_neg=with_neg),
                             wire_dtype=wire_dtype)
  if dedup is not None:
    kw = {} if mod is glt else dict(device='cpu')
    # the stream's sampler at the worker seed, on another engine
    p._sampler = mod.sampler.NeighborSampler(ds.graph, fan, seed=3 * 1000003,
                                             dedup=dedup, **kw)
  return p


def _blocks(p):
  nb = p.num_batches()
  return [(1, 0, 2), (1, nb - 1, 1)]


@pytest.fixture(scope='module')
def frames():
  """name -> [(block, JAX frame, port frame)], each producer built once."""
  out = {}
  for name, (pair, share, kind, fan, with_neg, dedup) in _streams().items():
    jds, ds, _ = pair
    jp = _producer(glt, jds, share, kind, fan, with_neg, dedup)
    tp = _producer(gtt, ds, share, kind, fan, with_neg, dedup)
    assert tp.num_batches() == jp.num_batches()
    assert tp._key_stride == jp._key_stride
    assert tp.plan.fingerprint_payload() == jp.plan.fingerprint_payload()
    out[name] = [(blk, jp.build_frame(*blk), tp.build_frame(*blk))
                 for blk in _blocks(jp)]
  return out


def assert_frames_equal(jf, tf, bf16=False):
  assert sorted(tf) == sorted(jf)
  for key, jv in jf.items():
    a, b = np.asarray(jv), tf[key]
    assert isinstance(b, np.ndarray), key
    if bf16 and (key == 'x' or key.startswith('x.')):
      assert b.dtype == np.uint16
      a = a.view(np.uint16)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=key)


@pytest.mark.parametrize('name', STREAMS)
def test_frames_match_jax(frames, name):
  for blk, jf, tf in frames[name]:
    assert_frames_equal(jf, tf)
    assert int(tf['#META.num_batches']) == blk[2]
    if name.startswith('link'):
      # the ack provenance of a link block: [k, 2, bs] edges, true sizes
      assert tf['#META.edge_batch'].shape == (blk[2], 2, BS)


def test_link_tail_batch_is_padded_cyclically(frames):
  (_, jf, tf), = [f for f in frames['link_binary'] if f[0][1] > 0]
  assert int(tf['#META.edge_batch_size'][0]) == 22 % BS
  np.testing.assert_array_equal(tf['#META.edge_batch_size'],
                                np.asarray(jf['#META.edge_batch_size']))


@pytest.mark.parametrize('name', ['node_merge', 'node_typed'])
def test_bf16_frames_match_jax_bits(name):
  pair, share, kind, fan, with_neg, dedup = _streams()[name]
  jp = _producer(glt, pair[0], share, kind, fan, with_neg, dedup, 'bf16')
  tp = _producer(gtt, pair[1], share, kind, fan, with_neg, dedup, 'bfloat16')
  assert tp.wire_dtype == 'bfloat16'
  jf, tf = jp.build_frame(0, 1, 2), tp.build_frame(0, 1, 2)
  assert_frames_equal(jf, tf, bf16=True)
  # the bits are the f32 frame's, rounded to nearest even
  f32 = _producer(gtt, pair[1], share, kind, fan, with_neg,
                  dedup).build_frame(0, 1, 2)
  for key in (k for k in tf if k == 'x' or k.startswith('x.')):
    want = torch.from_numpy(f32[key]).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(tf[key].view(np.int16), want.numpy())


def test_frame_is_random_access_and_cached_once():
  """A block is a pure function of (epoch, range): built out of order,
  built twice, produced then fetched, the bytes are the same; a produced
  frame is popped by its fetch and its bytes counted by the seams."""
  (_, ds, _), share = homo_data(), np.arange(3, 33)
  p = tbp.BlockSampleProducer(ds, share, config(gtt, 'NODE', [2, 2]))
  late = p.build_frame(2, 4, 2)
  early = p.build_frame(0, 0, 2)
  assert_frames_equal(late, p.build_frame(2, 4, 2))
  staged, fetched = [], []
  p.on_stage, p.on_fetch = staged.append, fetched.append
  assert p.produce(0, 0, 2) and p.produce(0, 0, 2)
  assert p.cached_blocks() == 1 and p.cached_bytes() == staged[0]
  assert staged == [tbp._frame_nbytes(early)]
  assert_frames_equal(early, p.fetch(0, 0, 2))
  assert fetched == staged and p.cached_blocks() == 0
  assert_frames_equal(early, p.fetch(0, 0, 2))   # rebuilt, uncharged
  assert fetched == staged
  assert [(r['epoch'], r['start'], r['k']) for r in p.build_log][:2] == \
      [(2, 4, 2), (0, 0, 2)]
  with pytest.raises(ValueError, match='outside'):
    p.build_frame(0, p.num_batches() - 1, 2)


def test_stack_block_frames_pads_pow2_like_jax():
  rng = np.random.default_rng(0)
  msgs = [dict(ids=rng.integers(0, 9, n).astype(np.int32),
               x=rng.standard_normal((n, 3)).astype(np.float32),
               mask=np.ones(n, bool), scalar=np.asarray(n, np.int32))
          for n in (5, 3, 7)]
  msgs[1]['only_here'] = np.zeros(2)
  jf = jbp.stack_block_frames(msgs)
  tf = tbp.stack_block_frames(msgs)
  assert sorted(tf) == sorted(jf) == ['ids', 'mask', 'scalar', 'x']
  for key in jf:
    assert tf[key].dtype == jf[key].dtype
    np.testing.assert_array_equal(tf[key], jf[key])
  assert tf['ids'].shape == (3, 8) and tf['ids'][1, 3] == tbp.INT32_MAX
  assert tf['x'][1, 3:].sum() == 0
  # the same messages as tensors stack alike (a producer's, pre-copy)
  tt = tbp.stack_block_frames([{k: torch.from_numpy(np.asarray(v))
                                for k, v in m.items()} for m in msgs])
  for key in jf:
    np.testing.assert_array_equal(tt[key].numpy(), jf[key])
  with pytest.raises(ValueError, match='closed-shape'):
    tbp.stack_block_frames([dict(a=np.zeros((2, 3))),
                            dict(a=np.zeros((2, 4)))])
  for arrs in ([np.zeros((3, 2), np.int64), np.zeros((5, 2), np.int64)],):
    for j, t in zip(jbp._pad_pow2_axis0(arrs), tbp._pad_pow2_axis0(arrs)):
      np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize('wire', [None, 'bf16', 'bfloat16'])
def test_block_mb_per_chunk_matches_jax(wire):
  for args in ((32, 938_000, 1_200_000, 100), (2, 96, 64, 4)):
    assert tbp.block_mb_per_chunk(*args, wire_dtype=wire) == \
        jbp.block_mb_per_chunk(*args, wire_dtype=wire)


def test_refusals_match_jax():
  (jds, ds, _), (tjds, tds, _) = homo_data(), typed_data()
  for mod, hds, tyds in ((glt, jds, tjds), (gtt, ds, tds)):
    bp = jbp if mod is glt else tbp
    with pytest.raises(ValueError, match='wire_dtype'):
      bp.BlockSampleProducer(hds, np.arange(8),
                             config(mod, 'NODE', [2]), wire_dtype='fp8')
    with pytest.raises(ValueError, match='NODE and LINK'):
      bp.BlockSampleProducer(hds, np.arange(8),
                             config(mod, 'SUBGRAPH', [2]))
    with pytest.raises(mod.sampler.CapacityPlanError):
      bp.BlockSampleProducer(tyds, np.arange(8),
                             config(mod, 'NODE', {UB: [2], BU: [2]}))
    with pytest.raises(mod.sampler.CapacityPlanError):
      bp.BlockSampleProducer(hds, ('user', np.arange(8)),
                             config(mod, 'NODE', [2]))


def test_launch_counters_are_exact_across_threads():
  """A server builds frames on several RPC threads of one process: every
  counter update holds the ops lock, so concurrent additions are all
  counted."""
  import threading
  from graphlearn_tpu_torch import ops
  before = ops.launch_counts()
  n, threads = 5000, 8

  def bump():
    for _ in range(n):
      ops.add_launch_counts({'gather_rows': 1, 'sample_level': 3})

  ts = [threading.Thread(target=bump) for _ in range(threads)]
  for t in ts:
    t.start()
  for t in ts:
    t.join()
  after = ops.launch_counts()
  assert after['gather_rows'] - before['gather_rows'] == n * threads
  assert after['sample_level'] - before['sample_level'] == 3 * n * threads
  ops.add_launch_counts({'gather_rows': -n * threads,
                         'sample_level': -3 * n * threads})
  assert ops.launch_counts() == before
