"""The port's tree sampler against the JAX sampler: the whole stream.

Same graph, same seed, same seed batches: every field of every batch is
equal, and so are the host call counters (the fold_in stream position).
Mirrors the whole-stream check of tests/test_ops.py.
"""
import numpy as np
import pytest

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt


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
  rng = np.random.default_rng(0)
  ei = rng.integers(0, 10, (2, 40))
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=10), device='cpu')
  for kwargs in (dict(dedup='map_table'), dict(with_weight=True),
                 dict(node_budget=5), dict(strategy='block'),
                 dict(padded_window=8), dict(with_edge=True)):
    with pytest.raises(NotImplementedError):
      gtt.sampler.NeighborSampler(tg, [2], device='cpu', **kwargs)
