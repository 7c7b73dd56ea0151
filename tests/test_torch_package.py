"""Package rules of the port.

(a) No module of graphlearn_tpu_torch imports jax or graphlearn_tpu.
(b) No entry point runs on the CPU unless asked: without a GPU, building
    a Dataset, NeighborLoader, NeighborSampler or GraphSAGE (tree or
    merge forward) with no ``device`` raises.
(c) On CPU tensors the kernel wrappers take their plain versions and the
    launch counters stay 0.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import ops

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'graphlearn_tpu')

class Block:
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in BLOCKED:
      raise ImportError(f'blocked import of {name}')
    return None

sys.meta_path.insert(0, Block())
import graphlearn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + '.')]
for name in names:
  importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def test_port_never_imports_jax():
  proc = subprocess.run([sys.executable, '-c', _BLOCKED_IMPORTS],
                        cwd=ROOT, capture_output=True, text=True,
                        timeout=120)
  assert proc.returncode == 0, proc.stderr
  expected = [m.name for m in pkgutil.walk_packages(gtt.__path__,
                                                    'graphlearn_tpu_torch.')]
  assert int(proc.stdout.split()[-1]) == len(expected) >= 20


@pytest.fixture
def no_gpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _cpu_dataset():
  rng = np.random.default_rng(0)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(rng.integers(0, 20, (2, 80)), num_nodes=20)
  ds.init_node_features(rng.standard_normal((20, 4)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, 3, 20))
  return ds


def test_entry_points_default_to_the_card(no_gpu):
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.data.Dataset()
  ds = _cpu_dataset()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.loader.NeighborLoader(ds, [2], np.arange(5), batch_size=4)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.loader.NeighborLoader(ds, [2], np.arange(5), batch_size=4,
                              dedup='auto', frontier_caps='auto')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.sampler.NeighborSampler(ds.graph, [2])
  no, eo = gtt.sampler.tree_layout(4, [2])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.models.GraphSAGE(4, 8, 3, num_layers=1, hop_node_offsets=no,
                         hop_edge_offsets=eo, tree_dense=True, fanouts=[2])
  no, eo = gtt.models.train.merge_hop_offsets(4, [2])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.models.GraphSAGE(4, 8, 3, num_layers=1, hop_node_offsets=no,
                         hop_edge_offsets=eo, merge_dense=True, fanouts=[2])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.data.Graph(ds.graph.topo)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.data.Feature(np.zeros((3, 2), np.float32))


def test_cpu_tensors_take_the_plain_path(no_gpu):
  ops.reset_launch_counts()
  ds = _cpu_dataset()
  loader = gtt.loader.NeighborLoader(ds, [3, 2], np.arange(10),
                                     batch_size=4, device='cpu')
  batches = list(loader)
  assert len(batches) == 3
  x = batches[0].x
  assert x.device.type == 'cpu' and x.shape == (4 + 12 + 24, 4)
  assert ops.launch_counts() == {'gather_rows': 0, 'sample_hop': 0,
                                 'sample_level': 0}


def test_kernel_wrappers_refuse_mixed_devices():
  table = torch.zeros((4, 2))
  ids = torch.zeros(3, dtype=torch.int32, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    ops.gather_rows_hbm(table, ids)
  ind = torch.zeros(5, dtype=torch.int32)
  epos = torch.zeros((2, 2), dtype=torch.int32, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    ops.sample_hop(ind, epos)
  mask = torch.ones((2, 2), dtype=torch.bool)
  with pytest.raises(ValueError, match='CUDA'):
    ops.sample_level(ind, epos, mask, ind[:2], torch.tensor(1, dtype=torch.int32),
                     4, 10)
  assert ops.launch_counts() == {'gather_rows': 0, 'sample_hop': 0,
                                 'sample_level': 0}
