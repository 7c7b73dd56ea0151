"""``GLT_STRICT``'s guard (``graphlearn_tpu_torch.utils.strict``) against
JAX's ``graphlearn_tpu/utils/strict.py``.

``strict_enabled`` reads the env var as JAX's does (set, and not '' or
'0'). ``strict_guards`` sets the card's sync debug mode to 'error' and
restores the previous mode on exit, nesting included; ``explicit`` (the
counterpart of JAX's explicit ``device_get``) turns it off inside a
region and back on. A CPU build of torch cannot set the mode, so the
tests record the ``(get, set)`` calls through a stand-in and hold the
exact sequence each of JAX's six guarded regions makes: ``ScanTrainer``,
``DistScanTrainer``, ``RunTrainer``, ``TieredScanTrainer`` (its
prologue's plan fetch let through), the materializer's passes and
``RemoteScanTrainer``. A chunk-boundary hook runs inside the region
(mode 'error'); the epoch-end publish runs outside it (the mode
restored). On a card, ``tests/test_torch_cuda.py`` shows a guarded epoch
raising on an injected ``.item()``.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu.utils import strict as jstrict
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.utils import strict

from test_torch_remote_scan import servers  # noqa: F401 - fixture
from test_torch_remote_scan import model as remote_model
from test_torch_remote_scan import trainer as remote_trainer

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 96, 6, 3


@pytest.mark.parametrize('value', [None, '', '0', '1', 'yes'])
def test_strict_enabled_reads_the_env_as_jax(monkeypatch, value):
  if value is None:
    monkeypatch.delenv('GLT_STRICT', raising=False)
  else:
    monkeypatch.setenv('GLT_STRICT', value)
  assert strict.strict_enabled() == jstrict.strict_enabled()
  assert strict.strict_enabled() == (value not in (None, '', '0'))
  assert strict.ENV_VAR == jstrict.ENV_VAR


class SyncMode:
  """A stand-in for ``torch.cuda.get_sync_debug_mode`` /
  ``set_sync_debug_mode``: the current mode and every set call."""

  def __init__(self):
    self.mode, self.sets = 0, []

  def get(self):
    return self.mode

  def set(self, mode):
    self.sets.append(mode)
    self.mode = mode


@pytest.fixture
def sync(monkeypatch):
  rec = SyncMode()
  monkeypatch.setattr(strict, '_sync_api', lambda: (rec.get, rec.set))
  monkeypatch.setenv('GLT_STRICT', '1')
  return rec


def test_guard_sets_error_and_restores_nesting_included(sync):
  with strict.strict_guards():
    assert sync.mode == 'error'
    with strict.strict_guards():
      assert sync.mode == 'error'
      with strict.explicit():
        assert sync.mode == 0
      assert sync.mode == 'error'
    assert sync.mode == 'error'
  assert sync.mode == 0
  assert sync.sets == ['error', 'error', 0, 'error', 'error', 0]
  with pytest.raises(KeyError):
    with strict.strict_guards():
      raise KeyError('the mode is restored on the way out')
  assert sync.mode == 0


def test_guard_is_a_no_op_without_glt_strict(sync, monkeypatch):
  monkeypatch.setenv('GLT_STRICT', '0')
  with strict.strict_guards(), strict.explicit():
    pass
  assert sync.sets == []


def test_no_card_no_calls(monkeypatch):
  """Without a card the guard makes no call (a CPU build cannot)."""
  monkeypatch.setenv('GLT_STRICT', '1')
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  with strict.strict_guards():
    pass


def _graph():
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _dataset(features=None):
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  if features is not None:
    ds.node_features = features(feats)
  return ds


def _model():
  return gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                              generator=torch.Generator().manual_seed(0))


def _pool():
  return np.random.default_rng(9).permutation(N)[:32].astype(np.int64)


def _observe(trainer, sync, seen):
  """Record the mode a chunk-boundary hook and the epoch-end publish
  see."""
  trainer.stage_hook = lambda c, start, k: seen.append(('hook', sync.mode))
  publish = trainer._epoch_end_publish

  def observed():
    seen.append(('publish', sync.mode))
    publish()

  trainer._epoch_end_publish = observed


def _local(cls, **kw):
  model = _model()
  loader = gtt.loader.NeighborLoader(_dataset(), [3, 2], _pool(),
                                     batch_size=8, device='cpu')
  return cls(loader, model, C, chunk_size=2, **kw), \
      ttrain.create_train_state(model)


def _dist():
  from test_torch_dist_scan import port_loader, port_model
  model = port_model()
  return gtt.loader.DistScanTrainer(port_loader(2, np.arange(8)), model, 3,
                                    chunk_size=2), \
      ttrain.create_train_state(model)


def _tiered():
  model = _model()
  ds = _dataset(lambda f: gtt.storage.TieredFeature(f, hot_rows=16,
                                                    device='cpu'))
  loader = gtt.loader.NeighborLoader(ds, [3, 2], _pool(), batch_size=8,
                                     device='cpu')
  return gtt.storage.TieredScanTrainer(loader, model, C, chunk_size=2), \
      ttrain.create_train_state(model)


SITES = {
    'ScanTrainer': lambda: _local(gtt.loader.ScanTrainer),
    'RunTrainer': lambda: _local(gtt.RunTrainer, epochs=2),
    'DistScanTrainer': _dist,
    'TieredScanTrainer': _tiered,
}
# per epoch, the set calls: the guard's, and inside it the first epoch's
# one upload of the seed pool (let through); the tiered prologue's plan
# fetch is let through every epoch
FIRST = ['error', 0, 'error', 0]
LATER = ['error', 0]
TIERED = ['error', 0, 'error', 0, 'error', 0]


@pytest.mark.parametrize('site', sorted(SITES))
def test_each_trainer_guards_its_epoch_body_only(sync, site):
  trainer, state = SITES[site]()
  seen = []
  _observe(trainer, sync, seen)
  for epoch in range(2):
    sync.sets.clear()
    seen.clear()
    state, losses, _ = trainer.run_epoch(state)
    want = (TIERED[:2] + LATER if epoch else TIERED) \
        if site == 'TieredScanTrainer' else (LATER if epoch else FIRST)
    assert sync.sets == want, (site, epoch)
    assert sync.mode == 0
    hooks = [m for what, m in seen if what == 'hook']
    assert hooks and set(hooks) == {'error'}, site
    assert seen[-1] == ('publish', 0), site
    assert torch.isfinite(losses).all()
  if site == 'TieredScanTrainer':
    trainer._stager.close()


def test_the_materializer_guards_each_pass(sync):
  from graphlearn_tpu_torch.serving import EmbeddingMaterializer
  mat = EmbeddingMaterializer(_dataset(), _model(), block_size=32,
                              chunk_size=2)
  emb = mat.materialize()
  # the block COO's one upload, before the first pass (let through,
  # outside any region), then per layer pass the guard
  assert sync.sets == [0, 0, 'error', 0, 'error', 0]
  assert sync.mode == 0 and emb.shape[0] >= N


def test_the_remote_scan_trainer_guards_its_body(sync, servers):  # noqa: F811
  servers(1)
  m = remote_model()
  tr = remote_trainer(m)
  seen = []
  tr.stage_hook = lambda c, start, k: seen.append(sync.mode)
  state = ttrain.create_train_state(m)
  state, losses, _ = tr.run_epoch(state)
  assert sync.sets == ['error', 0] and sync.mode == 0
  assert seen and set(seen) == {'error'}
  tr.shutdown()
