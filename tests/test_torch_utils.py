"""The port's ``utils`` against the JAX package's, on the CPU.

Each host helper (``topo``, ``common``, ``tensor``, ``units``,
``CastMixin``, ``Singleton``, ``python_exit_status``) gives JAX's
answer. ``CheckpointManager`` mirrors ``tests/test_loader.py``'s
checkpoint tests on the port's loaders: a restored state equals the
saved one exactly, a restored loader draws the same remaining
permutations as the uninterrupted run, and a mid-epoch resume (the
``NeighborLoader`` ``state_dict`` taken through the manager's JSON and
back) yields exactly the batches of JAX's own continuation; retention
keeps ``max_to_keep`` steps; the link loader resumes as well.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import utils as tu
from graphlearn_tpu.utils import (common as jcommon, tensor as jtensor,
                                  topo as jtopo, units as junits)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _coo(seed=0, n=30, e=90):
  rng = np.random.default_rng(seed)
  return (rng.integers(0, n, e), rng.integers(0, n, e), n,
          rng.integers(0, 10 ** 6, e), rng.random(e).astype(np.float32))


def _eq(a, b):
  assert len(a) == len(b)
  for x, y in zip(a, b):
    if x is None or y is None:
      assert x is None and y is None
      continue
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('with_ids', [False, True])
def test_topo_equals_jax(with_ids):
  row, col, n, eids, w = _coo()
  kw = dict(edge_ids=eids, edge_weights=w) if with_ids else {}
  _eq(tu.coo_to_csr(row, col, n, **kw), jtopo.coo_to_csr(row, col, n, **kw))
  _eq(tu.coo_to_csr(row, col), jtopo.coo_to_csr(row, col))
  _eq(tu.coo_to_csc(row, col, n, **kw), jtopo.coo_to_csc(row, col, n, **kw))
  indptr, indices, _, _ = jtopo.coo_to_csr(row, col, n)
  _eq(tu.csr_to_coo(indptr, indices), jtopo.csr_to_coo(indptr, indices))
  ids = eids if with_ids else None
  _eq(tu.csr_to_csc(indptr, indices, ids),
      jtopo.csr_to_csc(indptr, indices, ids))
  _eq([tu.ptr2ind(indptr)], [jtopo.ptr2ind(indptr)])
  _eq([tu.ind2ptr(np.sort(row), n)], [jtopo.ind2ptr(np.sort(row), n)])


def test_common_helpers_equal_jax(tmp_path):
  a, b = {}, {}
  for d in ({'x': 1, 'y': 2}, {'x': 3}):
    assert tu.merge_dict(d, a) == jcommon.merge_dict(d, b)
  a, b = {}, {}
  for i, d in enumerate(({'p': np.zeros(3)}, {'q': np.zeros(2)},
                         {'p': np.zeros(5), 'q': None}), start=1):
    assert tu.count_dict(d, a, i) == jcommon.count_dict(d, b, i)
  port = tu.get_free_port()
  assert isinstance(port, int) and 0 < port < 65536
  src = tmp_path / 'helper_mod.py'
  src.write_text('VALUE = 41\ndef f():\n  return VALUE + 1\n')
  mod = tu.load_module(str(src))
  assert mod.f() == jcommon.load_module(str(src)).f() == 42
  assert mod.__name__ == '_glt_mod_helper_mod'


def test_tensor_helpers_equal_jax():
  ids = np.array([5, 2, 7, 0])
  _eq([tu.id2idx(ids)], [jtensor.id2idx(ids)])
  _eq([tu.id2idx(ids, 10)], [jtensor.id2idx(ids, 10)])
  t = torch.arange(6).reshape(2, 3)
  _eq([tu.convert_to_array(t)], [jtensor.convert_to_array(t)])
  got = tu.convert_to_array({'a': t, 'b': [1, 2]}, np.float32)
  want = jtensor.convert_to_array({'a': t, 'b': [1, 2]}, np.float32)
  assert got.keys() == want.keys()
  for k in got:
    _eq([got[k]], [want[k]])
  assert tu.convert_to_array(None) is None
  assert tu.squeeze_dict({'a': 1}) == jtensor.squeeze_dict({'a': 1}) == 1
  assert tu.squeeze_dict({'a': 1, 'b': 2}) == {'a': 1, 'b': 2}


@pytest.mark.parametrize('size', [1024, '10GB', '512M', '1.5k', '3 tb',
                                  '7'])
def test_units_equal_jax(size):
  assert tu.parse_size(size) == junits.parse_size(size)
  n = tu.parse_size(size)
  assert tu.format_size(n) == junits.format_size(n)
  with pytest.raises(ValueError):
    tu.parse_size('3 parsecs')


def test_cast_mixin_has_one_home_and_singleton_and_exit_status():
  from graphlearn_tpu_torch.sampler import base
  assert base.CastMixin is tu.CastMixin
  ns = gtt.sampler.NegativeSampling.cast(('binary', 2))
  assert (ns.mode, ns.amount) == ('binary', 2)
  assert gtt.sampler.NegativeSampling.cast(ns) is ns
  assert gtt.sampler.NegativeSampling.cast(None) is None
  assert gtt.sampler.NegativeSampling.cast(
      {'mode': 'triplet', 'amount': 1}).mode == 'triplet'

  class One(metaclass=tu.Singleton):
    def __init__(self, v):
      self.v = v
  assert One(1) is One(2) and One(3).v == 1
  assert tu.python_exit_status() is False


# ------------------------------------------------------------ checkpoints

def _datasets(seed, n, e, f):
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  x = rng.standard_normal((n, f)).astype(np.float32)
  y = rng.integers(0, 3, n)
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  jds.init_node_features(x)
  jds.init_node_labels(y)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=n)
  tds.init_node_features(x)
  tds.init_node_labels(y)
  return jds, tds


def _nodes(loader):
  return [np.asarray(b.node) if not torch.is_tensor(b.node)
          else b.node.numpy() for b in loader]


def _assert_runs_equal(a, b):
  assert len(a) == len(b) > 0
  for x, y in zip(a, b):
    np.testing.assert_array_equal(x, y)


def test_checkpoint_resume_training():
  """Train two epochs and save; restore into a fresh model, optimizer
  and loader: the parameters and Adam's moments equal the saved ones
  exactly, and the restored loader draws the uninterrupted run's next
  epoch, which is also JAX's."""
  n = 100
  jds, tds = _datasets(0, n, 600, 8)

  def loaders():
    kw = dict(batch_size=16, shuffle=True, drop_last=True, seed=7)
    return (glt.loader.NeighborLoader(jds, [3, 2], np.arange(n), **kw),
            gtt.loader.NeighborLoader(tds, [3, 2], np.arange(n),
                                      device='cpu', **kw))

  def model(seed):
    return gtt.models.GraphSAGE(8, 8, 3, num_layers=2, device='cpu',
                                generator=torch.Generator().manual_seed(seed))
  jl, tl = loaders()
  tm = model(0)
  state = gtt.models.create_train_state(tm)
  step, _ = gtt.models.make_train_step(tm, 3)
  for _ in range(2):
    for b in tl:
      state, loss, _ = step(state, gtt.models.batch_to_dict(b))
    for _ in jl:
      pass
  with tempfile.TemporaryDirectory() as d:
    mgr = tu.CheckpointManager(d, max_to_keep=2)
    mgr.save(2, {'model': tm, 'train': state}, loader=tl,
             extra={'epoch': 2})
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
    cont = _nodes(tl)
    _assert_runs_equal(cont, _nodes(jl))           # JAX's next epoch
    _, tl2 = loaders()
    tm2 = model(1)
    tmpl = {'model': tm2, 'train': gtt.models.create_train_state(tm2)}
    restored, extra = mgr.restore(tmpl, loader=tl2)
    assert extra == {'epoch': 2}
    assert restored['model'] is tm2
    assert restored['train'].step == state.step == 12
    for (name, a), (_, b) in zip(tm.state_dict().items(),
                                 tm2.state_dict().items()):
      assert torch.equal(a, b), name
    sa = state.optimizer.state_dict()['state']
    sb = restored['train'].optimizer.state_dict()['state']
    for k in sa:
      for m in ('exp_avg', 'exp_avg_sq', 'step'):
        assert torch.equal(torch.as_tensor(sa[k][m]),
                           torch.as_tensor(sb[k][m]))
    _assert_runs_equal(cont, _nodes(tl2))
    mgr.save(3, {'model': tm, 'train': state})
    mgr.save(4, {'model': tm, 'train': state})
    assert mgr.all_steps() == [3, 4]
    assert not [f for f in os.listdir(d) if f.startswith('.tmp')]
    step2, _ = gtt.models.make_train_step(tm2, 3)
    _, loss, _ = step2(restored['train'],
                       gtt.models.batch_to_dict(next(iter(tl2))))
    assert torch.isfinite(loss)
    mgr.close()
  with tempfile.TemporaryDirectory() as d:
    with pytest.raises(FileNotFoundError):
      tu.CheckpointManager(d).restore({'w': np.zeros(1)})


def test_mid_epoch_resume_through_the_manager_equals_jax():
  """A snapshot after k batches, written and read back through the
  manager's JSON: a fresh port loader yields exactly the rest of JAX's
  epoch and its next epoch; an epoch-end snapshot resumes at the next
  epoch."""
  n = 128
  jds, tds = _datasets(1, n, 800, 4)
  kw = dict(batch_size=16, shuffle=True, drop_last=True, seed=11)

  def tloader():
    return gtt.loader.NeighborLoader(tds, [3, 2], np.arange(n),
                                     device='cpu', **kw)
  ref = glt.loader.NeighborLoader(jds, [3, 2], np.arange(n), **kw)
  it = iter(ref)
  k = 3
  for _ in range(k):
    next(it)
  want = [np.asarray(b.node) for b in it] + _nodes(ref)

  run = tloader()
  it = iter(run)
  for _ in range(k):
    next(it)
  with tempfile.TemporaryDirectory() as d:
    mgr = tu.CheckpointManager(d)
    mgr.save(0, {'w': np.zeros(1)}, loader=run)
    res = tloader()
    state, _ = mgr.restore({'w': np.ones(1)}, loader=res)
    np.testing.assert_array_equal(state['w'], np.zeros(1))
    _assert_runs_equal(want, _nodes(res) + _nodes(res))

    done = tloader()
    for _ in done:
      pass
    mgr.save(1, {'w': np.zeros(1)}, loader=done)
    after = _nodes(done)
    res2 = tloader()
    mgr.restore({'w': np.zeros(1)}, step=1, loader=res2)
    _assert_runs_equal(after, _nodes(res2))


def test_checkpoint_link_loader():
  rng = np.random.default_rng(0)
  n = 60
  rows, cols = rng.integers(0, n, 400), rng.integers(0, n, 400)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(np.stack([rows, cols]), num_nodes=n)

  def make():
    return gtt.loader.LinkNeighborLoader(
        tds, [2], np.stack([rows, cols]),
        neg_sampling=gtt.sampler.NegativeSampling('binary', 1),
        batch_size=16, shuffle=True, seed=3, device='cpu')
  loader = make()
  for _ in loader:
    pass
  with tempfile.TemporaryDirectory() as d:
    mgr = tu.CheckpointManager(d)
    mgr.save(1, {'w': np.zeros(1)}, loader=loader)
    cont = [(b.node, b.metadata['edge_label_index']) for b in loader]
    l2 = make()
    mgr.restore({'w': np.zeros(1)}, loader=l2)
    resumed = [(b.node, b.metadata['edge_label_index']) for b in l2]
  assert len(cont) == len(resumed) > 0
  for (n1, e1), (n2, e2) in zip(cont, resumed):
    assert torch.equal(n1, n2) and torch.equal(e1, e2)
