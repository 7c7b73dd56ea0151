"""The port's tree sampler against the JAX sampler: the whole stream.

Same graph, same seed, same seed batches: every field of every batch is
equal, and so are the host call counters (the fold_in stream position).
Mirrors the whole-stream check of tests/test_ops.py.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _fields(out):
  return {
      'node': np.asarray(out.node), 'row': np.asarray(out.row),
      'col': np.asarray(out.col), 'edge_mask': np.asarray(out.edge_mask),
      'num_nodes': np.asarray(out.num_nodes),
      'num_sampled_nodes': np.asarray([int(c) for c in out.num_sampled_nodes]),
      'num_sampled_edges': np.asarray([int(c) for c in out.num_sampled_edges]),
  }


def _tfields(out):
  return {
      'node': out.node.numpy(), 'row': out.row.numpy(),
      'col': out.col.numpy(), 'edge_mask': out.edge_mask.numpy(),
      'num_nodes': out.num_nodes.numpy(),
      'num_sampled_nodes': np.asarray([int(c) for c in out.num_sampled_nodes]),
      'num_sampled_edges': np.asarray([int(c) for c in out.num_sampled_edges]),
  }


@pytest.mark.parametrize('fanouts,window', [([4, 3], 512), ([6, 2, 3], 128)])
def test_tree_sampler_stream_matches_jax(fanouts, window):
  rng = np.random.default_rng(6)
  n, e = 200, 3000
  rows = rng.integers(0, n, e)
  # a hub row above the window exercises the JAX kernel's unstaged branch
  rows[:300] = 7
  cols = rng.integers(0, n, e)
  ei = np.stack([rows, cols])
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  np.testing.assert_array_equal(tg.indices.numpy(), jg.topo.indices)
  js = glt.sampler.NeighborSampler(jg, fanouts, seed=11, dedup='tree',
                                   use_fused_hop='interpret',
                                   fused_hop_window=window)
  ts = gtt.sampler.NeighborSampler(tg, fanouts, seed=11, dedup='tree',
                                   device='cpu')
  for step in range(3):
    seeds = np.concatenate([[7, n - 1], rng.integers(0, n, 12)])
    cap = 16 if step < 2 else None    # a padded and a rounded-up batch
    a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap)
    b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds),
                             batch_cap=cap)
    fa, fb = _fields(a), _tfields(b)
    for name in fa:
      np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
  assert ts._call_count == js._call_count == 3
  state = ts.state_dict()
  assert state['base_key'] == np.asarray(js._key).tolist()


def test_sampler_refuses_later_slices():
  """Typed graphs, per-edge-type fanouts and typed link sampling, refused
  before their slices, now sample and equal the JAX sampler's batches,
  as do ``with_edge`` and the legacy ``map_table`` / ``sort_legacy``
  engines (edge ids included)."""
  rng = np.random.default_rng(0)
  ei = rng.integers(0, 10, (2, 40))
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=10), device='cpu')
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=10), 'CPU')
  et = ('a', 'r', 'b')
  from test_torch_hetero_sampler import assert_batches_equal
  for fanouts in ([2], {et: [2]}):
    ts = gtt.sampler.NeighborSampler({et: tg}, fanouts, device='cpu',
                                     seed=3)
    js = glt.sampler.NeighborSampler({et: jg}, fanouts, seed=3)
    for seeds in (np.array([0, 9, 9, 4]), np.arange(10)):
      assert_batches_equal(
          js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds, 'a')),
          ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds, 'a')))
  # typed link sampling, the last of these slices, equals JAX's too
  link = dict(input_type=et)
  assert_batches_equal(
      js.sample_from_edges(glt.sampler.EdgeSamplerInput(
          np.arange(3), np.arange(3), **link)),
      ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
          np.arange(3), np.arange(3), **link)))
  assert ts._call_count == js._call_count
  for kwargs in (dict(dedup='map_table'), dict(dedup='sort_legacy'),
                 dict(with_edge=True)):
    ts = gtt.sampler.NeighborSampler(tg, [2, 2], device='cpu', seed=3,
                                     **kwargs)
    js = glt.sampler.NeighborSampler(jg, [2, 2], seed=3, **kwargs)
    for seeds in (np.array([0, 9, 9, 4]), np.arange(10)):
      a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds))
      b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds))
      fa, fb = _fields(a), _tfields(b)
      for name in fa:
        np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
      assert (a.edge is None) == (b.edge is None)
      if b.edge is not None:
        np.testing.assert_array_equal(b.edge.numpy(), np.asarray(a.edge))
