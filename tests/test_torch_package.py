"""Package rules of the port.

(a) No module of graphlearn_tpu_torch imports jax or graphlearn_tpu.
(b) No entry point runs on the CPU unless asked: without a GPU, building
    a Dataset, NeighborLoader, NeighborSampler, GraphSAGE (segment, tree
    or merge forward), Feature, TieredFeature, EmbeddingStore,
    EmbeddingMaterializer or ServingEngine with no ``device`` raises, and so do the training
    example and the probe suites.
(c) On CPU tensors the kernel wrappers take their plain versions and the
    launch counters stay 0.
(d) Every kernel source under csrc/ has a SOURCES entry, and the link
    slice's kernel (negative_sample.cu) has its plain version.
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

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

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
  # the training slice's modules are among those imported under the block
  assert {'graphlearn_tpu_torch.recovery',
          'graphlearn_tpu_torch.recovery.checkpoint',
          'graphlearn_tpu_torch.recovery.snapshot',
          'graphlearn_tpu_torch.loader.run_epoch',
          'graphlearn_tpu_torch.loader.pipeline'} <= set(expected)
  # the sampling-menu slice's modules too
  assert {'graphlearn_tpu_torch.ops.negative',
          'graphlearn_tpu_torch.ops.induce',
          'graphlearn_tpu_torch.ops.induce_map',
          'graphlearn_tpu_torch.ops.subgraph',
          'graphlearn_tpu_torch.sampler.negative_sampler',
          'graphlearn_tpu_torch.loader.link_loader',
          'graphlearn_tpu_torch.loader.link_neighbor_loader',
          'graphlearn_tpu_torch.loader.subgraph_loader',
          'graphlearn_tpu_torch.examples.graph_sage_unsup'} <= set(expected)
  # the storage slice's modules too
  assert {'graphlearn_tpu_torch.storage',
          'graphlearn_tpu_torch.storage.disk',
          'graphlearn_tpu_torch.storage.staging',
          'graphlearn_tpu_torch.storage.planner',
          'graphlearn_tpu_torch.storage.tiered',
          'graphlearn_tpu_torch.storage.scan'} <= set(expected)


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
  ei = np.zeros((2, 4), np.int64)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.loader.LinkNeighborLoader(ds, [2], ei, batch_size=2)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.loader.LinkNeighborLoader(ds, [2], ei, batch_size=2,
                                  frontier_caps='auto')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.loader.SubGraphLoader(ds, [2], np.arange(4), batch_size=2)
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
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.storage.TieredFeature(np.zeros((3, 2), np.float32), hot_rows=1)
  # the serving tier: the store's device is its table's (host rows go to
  # the card), the materializer's its dataset's, the engine's its store's
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.serving.EmbeddingStore(np.zeros((5, 3), np.float32))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.serving.ServingEngine(
        gtt.serving.EmbeddingStore(np.zeros((5, 3), np.float32)))
  model = gtt.models.GraphSAGE(4, 8, 3, num_layers=2, device='cpu')
  ds.device = None
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.serving.EmbeddingMaterializer(ds, model)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    gtt.models.GraphSAGE(4, 8, 3, num_layers=2)
  # the training example and the probe suites: the card or nothing
  from graphlearn_tpu_torch.benchmarks import (prof_dedup, prof_gather_rows,
                                               prof_mem, prof_uva)
  from graphlearn_tpu_torch.examples import (graph_sage_unsup,
                                             train_sage_products)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    train_sage_products.main(['--num-nodes', '100'])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    graph_sage_unsup.main(['--num-nodes', '100'])
  for suite in (prof_mem, prof_dedup, prof_uva, prof_gather_rows):
    with pytest.raises(SystemExit, match='no CUDA device'):
      suite.main([])


def test_cpu_tensors_take_the_plain_path(no_gpu):
  ops.reset_launch_counts()
  ds = _cpu_dataset()
  loader = gtt.loader.NeighborLoader(ds, [3, 2], np.arange(10),
                                     batch_size=4, device='cpu')
  batches = list(loader)
  assert len(batches) == 3
  x = batches[0].x
  assert x.device.type == 'cpu' and x.shape == (4 + 12 + 24, 4)
  assert ops.launch_counts() == {'gather_rows': 0, 'gather_runs': 0,
                                 'sample_hop': 0, 'sample_level': 0,
                                 'step_keys': 0, 'dist_step_keys': 0,
                                 'row_gather_probe_bulk': 0,
                                 'row_gather_probe_vector': 0,
                                 'smem_take': 0, 'uniform_draw': 0,
                                 'negative_sample': 0,
                                 'negative_sample_local': 0,
                                 'gather_unified': 0,
                                 'gather_rows_sharded': 0,
                                 'gather_unified_sharded': 0}


def test_kernel_wrappers_refuse_mixed_devices():
  table = torch.zeros((4, 2))
  ids = torch.zeros(3, dtype=torch.int32, device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    ops.gather_rows_hbm(table, ids)
  ind = torch.zeros(5, dtype=torch.int32)
  indptr = torch.tensor([0, 2, 5], dtype=torch.int32)
  seeds = torch.zeros(2, dtype=torch.int32, device='meta')
  mask = torch.ones(2, dtype=torch.bool)
  key = gtt.random.PRNGKey(0)
  with pytest.raises(ValueError, match='CUDA'):
    ops.sample_hop_fused(indptr, ind, None, seeds, mask, 2, key)
  state, _, _, _ = ops.init_node_merge(torch.zeros(2, dtype=torch.int32),
                                       mask, 8)
  with pytest.raises(ValueError, match='CUDA'):
    ops.sample_level_fused(indptr, ind, None, seeds, mask, 2, key, state,
                           torch.arange(2, dtype=torch.int32),
                           prefix_cap=2)
  with pytest.raises(ValueError, match='no kernel'):
    ops.draw.uniform(key, (3, 2), device='meta')
  with pytest.raises(ValueError, match='CUDA'):
    ops.random_negative_sample(indptr, ind.to('meta'), 2, 2, 4, key)
  with pytest.raises(ValueError, match='CUDA'):
    ops.dist_step_keys(key, torch.zeros((), dtype=torch.int64,
                                        device='meta'), 2, 4, 3)
  with pytest.raises(ValueError, match='CUDA'):
    ops.random_negative_sample_local(torch.zeros(2, dtype=torch.int32),
                                     indptr, ind.to('meta'), 4, 2, key)
  shards = [torch.zeros((2, 2)), torch.zeros((2, 2))]
  with pytest.raises(ValueError, match='CUDA'):
    ops.gather_rows_sharded(shards, None, ids)
  with pytest.raises(ValueError, match='CUDA'):
    ops.gather_rows_unified_sharded(shards, None, torch.zeros((1, 2)), ids)
  assert ops.launch_counts() == {'gather_rows': 0, 'gather_runs': 0,
                                 'sample_hop': 0, 'sample_level': 0,
                                 'step_keys': 0, 'dist_step_keys': 0,
                                 'row_gather_probe_bulk': 0,
                                 'row_gather_probe_vector': 0,
                                 'smem_take': 0, 'uniform_draw': 0,
                                 'negative_sample': 0,
                                 'negative_sample_local': 0,
                                 'gather_unified': 0,
                                 'gather_rows_sharded': 0,
                                 'gather_unified_sharded': 0}


def test_every_kernel_source_is_built_and_has_a_plain_version():
  from graphlearn_tpu_torch.ops import kernels, negative
  sources = {src for src, _ in kernels.SOURCES.values()}
  assert sources == {p.name for p in kernels.CSRC.glob('*.cu')}
  assert kernels.SOURCES['negative_sample'][0] == 'negative_sample.cu'
  assert 'glt_negative_sample' in kernels.SOURCES['negative_sample'][1]
  assert callable(negative.random_negative_sample_plain)
  assert callable(negative.negative_candidates_plain)
  text = (kernels.CSRC / 'negative_sample.cu').read_text()
  assert '#include "csr_pick.cuh"' in text   # the shared threefry
