"""The port's table datasets and its data-layer examples against the JAX
package's, on the CPU.

- ``TableDataset`` over ``.npy`` ([2, E] and [E, 2]) and ``.csv`` edge
  tables and ``.npz`` node tables, read on several threads: the CSR,
  the features (all on the host by default, as in JAX) and the labels
  equal; a table JAX refuses is refused; ``odps://`` without
  ``common_io`` and every vineyard adapter raise as JAX's do.
- ``examples/train_sage_papers_scale.py`` (hot/cold mode, at 20,000
  nodes) and ``examples/train_from_tables.py``: the JAX example run as it
  is, its initial parameters and per-step losses recorded, and the port's
  example from those parameters (``models.convert``): the same losses
  within rtol 1e-4 over the steps compared.
- the papers example's ``--spill-dir`` three-tier mode runs on the CPU.
- ``examples/feature_mp.py`` on the CPU: two spawned workers rebuild the
  store from its IPC handle and read exact rows.
"""
import argparse
import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.examples import feature_mp
from graphlearn_tpu_torch.examples import train_from_tables as tables_example
from graphlearn_tpu_torch.examples import train_sage_papers_scale as papers

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = 'cpu'


def _write(root, edge_fmt):
  rng = np.random.default_rng(4)
  n = 90
  rows, cols = rng.integers(0, n, 400), rng.integers(0, n, 400)
  edge_tables = []
  for s in range(2):
    ei = np.stack([rows[s::2], cols[s::2]])
    if edge_fmt == 'npy':
      path = os.path.join(root, f'e{s}.npy')
      np.save(path, ei if s == 0 else ei.T)
    else:
      path = os.path.join(root, f'e{s}.csv')
      np.savetxt(path, ei.T, delimiter=',', fmt='%d')
    edge_tables.append(path)
  feats = rng.standard_normal((n, 5)).astype(np.float32)
  labels = rng.integers(0, 4, n)
  node_tables = []
  for s in range(3):
    ids = np.arange(s, n, 3)[::-1]
    path = os.path.join(root, f'n{s}.npz')
    np.savez(path, ids=ids, feats=feats[ids], labels=labels[ids])
    node_tables.append(path)
  return edge_tables, node_tables, feats, labels


@pytest.mark.parametrize('edge_fmt', ['npy', 'csv'])
def test_table_dataset_matches_jax(tmp_path, edge_fmt):
  edge_tables, node_tables, feats, labels = _write(tmp_path, edge_fmt)
  jds = glt.data.TableDataset(edge_tables, node_tables, num_threads=3)
  ds = gtt.data.TableDataset(edge_tables, node_tables, num_threads=3,
                             device=CPU)
  np.testing.assert_array_equal(ds.graph.topo.indptr, jds.graph.topo.indptr)
  np.testing.assert_array_equal(ds.graph.indices.numpy(),
                                np.asarray(jds.graph.indices))
  assert ds.graph.mode == jds.graph.mode == 'HBM'
  np.testing.assert_array_equal(ds.node_labels.numpy(), jds.node_labels)
  f = ds.node_features
  assert f.split_ratio == 0.0 and f.device_table() is None
  assert f.unified.host_rows == feats.shape[0]
  ids = np.random.default_rng(0).integers(0, feats.shape[0], 50)
  np.testing.assert_array_equal(f[ids].numpy(),
                                np.asarray(jds.node_features[ids]))
  np.testing.assert_array_equal(f[ids].numpy(), feats[ids])


def test_table_dataset_split_ratio_and_refusals(tmp_path):
  edge_tables, node_tables, feats, _ = _write(tmp_path, 'npy')
  ds = gtt.data.TableDataset(edge_tables, node_tables, split_ratio=0.5,
                             device=CPU)
  assert ds.node_features.unified.host_rows == 45
  bad = os.path.join(tmp_path, 'bad.csv')
  np.savetxt(bad, np.ones((3, 2)), delimiter=',')
  for pkg in (glt, gtt):
    kw = {} if pkg is glt else dict(device=CPU)
    with pytest.raises(ValueError, match='ids \\+ feats'):
      pkg.data.TableDataset(edge_tables, [bad], **kw)
    with pytest.raises(ValueError, match='unsupported table format'):
      pkg.data.TableDataset([os.path.join(tmp_path, 'e.parquet')], **kw)


def test_odps_and_vineyard_refusals():
  for pkg in (glt, gtt):
    kw = {} if pkg is glt else dict(device=CPU)
    with pytest.raises(ImportError, match='common_io'):
      pkg.data.TableDataset(['odps://project/tables/edges'], **kw)
    v = pkg.data.vineyard_utils
    with pytest.raises(ImportError, match='vineyard'):
      v.vineyard_to_csr('sock', 'oid', 0, 0)
    with pytest.raises(ImportError, match='vineyard'):
      v.load_vertex_feature_from_vineyard('sock', 'oid', ['a'], 0)
    with pytest.raises(ImportError, match='vineyard'):
      v.load_edge_feature_from_vineyard('sock', 'oid', ['a'], 0)


# ------------------------------------------------------------- examples


def _jax_example(monkeypatch, name, argv, max_steps):
  """The JAX example ``name`` as it is, with its initial parameters and
  its first ``max_steps`` per-step losses recorded (later steps skipped)."""
  spec = importlib.util.spec_from_file_location(
      f'jax_{name}', ROOT / 'examples' / f'{name}.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  rec = {'losses': []}
  create, make_step = jtrain.create_train_state, jtrain.make_train_step

  def create_and_record(*a, **kw):
    state, tx = create(*a, **kw)
    rec['params0'] = jax.tree.map(np.asarray, state.params)
    return state, tx

  def make_recording_step(*a, **kw):
    step, eval_step = make_step(*a, **kw)

    def recording_step(state, batch):
      if len(rec['losses']) >= max_steps:
        zero = jax.numpy.zeros(())
        return state, zero, zero
      out = step(state, batch)
      rec['losses'].append(float(out[1]))
      return out

    return recording_step, eval_step

  monkeypatch.setattr(jtrain, 'create_train_state', create_and_record)
  monkeypatch.setattr(jtrain, 'make_train_step', make_recording_step)
  monkeypatch.setattr(glt.utils, 'enable_compilation_cache',
                      lambda *a, **kw: None)
  monkeypatch.setattr(sys, 'argv', [f'{name}.py'] + argv)
  mod.main()
  return rec


def test_papers_scale_losses_track_the_jax_example(monkeypatch):
  argv = ['--num-nodes', '20000', '--hot-gb', '0.004', '--steps', '4',
          '--batch-size', '32']
  rec = _jax_example(monkeypatch, 'train_sage_papers_scale', argv, 5)
  args = papers.parser().parse_args(argv + ['--device', 'cpu'])
  result, losses = papers.run(args, rec['params0'])
  assert 0 < result['split_ratio'] < 1 and result['steps'] == 4
  assert 0 < result['hot_hit_rate'] < 1
  assert len(losses) == len(rec['losses']) == 5
  np.testing.assert_allclose(losses, rec['losses'], rtol=1e-4, atol=0)


def test_papers_scale_spill_dir_is_not_ported(tmp_path):
  """``--spill-dir`` was refused until the storage slice; it now runs the
  three-tier mode (its JAX parity: tests/test_torch_storage_scan.py), and
  refuses a split that leaves the disk tier empty."""
  argv = ['--num-nodes', '4000', '--feat-dim', '8', '--hot-gb', '0.00005',
          '--warm-gb', '0.00003', '--steps', '3', '--batch-size', '8',
          '--chunk-size', '2', '--device', 'cpu']
  args = papers.parser().parse_args(argv + ['--spill-dir', str(tmp_path)])
  result, losses = papers.run(args)
  assert result['steps'] == len(losses) == 3
  assert result['tiers']['disk'] > 0 and result['plan']['chunks'] == 2
  assert np.isfinite(losses).all()
  args = papers.parser().parse_args(
      argv[:-2] + ['--warm-gb', '1', '--spill-dir', str(tmp_path / 'b'),
                   '--device', 'cpu'])
  with pytest.raises(ValueError, match='disk tier'):
    papers.run(args)


def test_tables_losses_track_the_jax_example(monkeypatch):
  steps = 8
  rec = _jax_example(monkeypatch, 'train_from_tables', [], steps)
  args = argparse.Namespace(epochs=1, lr=3e-3, seed=0, device='cpu')
  # the first epoch's steps; the JAX run recorded its first ``steps``
  result, losses = tables_example.run(args, rec['params0'])
  assert result['num_nodes'] == 20_000
  assert len(rec['losses']) == steps and len(losses) > steps
  np.testing.assert_allclose(losses[:steps], rec['losses'], rtol=1e-4,
                             atol=0)


def test_feature_mp_workers_read_exact_rows_on_the_cpu():
  assert feature_mp.run('cpu') == [(0, 'ok'), (1, 'ok')]
