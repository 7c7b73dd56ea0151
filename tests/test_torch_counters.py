"""The reference's kernel-path counters in the port, against the JAX
package's, on the CPU.

Each case makes the same calls through both packages and compares the
counter's delta: ``ops.fused_hop_calls`` (one per tree sampler call,
which the port always routes through its hop kernel's entry point, as the
JAX sampler does under ``use_fused_hop``), ``ops.fused_level_calls`` (one
per merge sampler call; the legacy ``map_table`` / ``sort_legacy``
engines count hop calls, and a link batch counts one call of its
engine), and ``ops.gather_runs`` / ``ops.gather_fallbacks``
(one per gather-v2 call that launches its kernel, or that does not: on the
CPU no call launches it, so every call counts a fallback in both
packages). The counts are exact. The port's own launch counter of the
negative sampling kernel stays 0 on the CPU, where the plain version
runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
from graphlearn_tpu import metrics as jmetrics
from graphlearn_tpu import ops as jops
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch import metrics, ops

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)


def _count(registry, name):
  return registry.snapshot()['counters'].get(name, 0)


def _graph(n=120, e=1500, seed=3):
  rng = np.random.default_rng(seed)
  return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), n, rng


def _sampler_calls(dedup):
  ei, n, rng = _graph()
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  js = glt.sampler.NeighborSampler(jg, [3, 2], seed=1, dedup=dedup,
                                   use_fused_hop=True)
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=1, dedup=dedup,
                                   device='cpu')
  batches = [rng.integers(0, n, 8) for _ in range(3)]

  def jax_calls():
    for seeds in batches:
      js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds))

  def port_calls():
    for seeds in batches:
      ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds))

  return jax_calls, port_calls


def _link_calls(dedup):
  ei, n, rng = _graph()
  jg = glt.data.Graph(glt.data.Topology(ei, num_nodes=n), 'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n), device='cpu')
  js = glt.sampler.NeighborSampler(jg, [3, 2], seed=1, dedup=dedup,
                                   use_fused_hop=True)
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=1, dedup=dedup,
                                   device='cpu')
  picks = [rng.integers(0, ei.shape[1], 6) for _ in range(3)]

  def jax_calls():
    for p in picks:
      js.sample_from_edges(glt.sampler.EdgeSamplerInput(
          ei[0][p], ei[1][p], neg_sampling=glt.sampler.NegativeSampling()))

  def port_calls():
    for p in picks:
      ts.sample_from_edges(gtt.sampler.EdgeSamplerInput(
          ei[0][p], ei[1][p], neg_sampling=gtt.sampler.NegativeSampling()))

  return jax_calls, port_calls


def _gather_calls():
  rng = np.random.default_rng(4)
  table = rng.standard_normal((50, 128)).astype(np.float32)
  ids = [rng.integers(-3, 55, 40).astype(np.int32),
         np.zeros(0, np.int32), np.arange(10, 30, dtype=np.int32)]

  def jax_calls():
    for i in ids:
      jops.gather_rows_hbm2(jnp.asarray(table), jnp.asarray(i))

  def port_calls():
    for i in ids:
      ops.gather_rows_hbm2(torch.as_tensor(table), torch.as_tensor(i))

  return jax_calls, port_calls


@pytest.mark.parametrize('name,calls,expect', [
    ('ops.fused_hop_calls', lambda: _sampler_calls('tree'), 3),
    ('ops.fused_level_calls', lambda: _sampler_calls('merge'), 3),
    ('ops.fused_hop_calls', lambda: _sampler_calls('map_table'), 3),
    ('ops.fused_hop_calls', lambda: _sampler_calls('sort_legacy'), 3),
    ('ops.fused_level_calls', lambda: _link_calls('merge'), 3),
    ('ops.fused_hop_calls', lambda: _link_calls('tree'), 3),
    ('ops.gather_runs', _gather_calls, 0),
    ('ops.gather_fallbacks', _gather_calls, 3),
])
def test_counter_delta_matches_jax(name, calls, expect):
  jax_calls, port_calls = calls()
  jreg, treg = jmetrics.default_registry(), metrics.default_registry()
  j0, t0 = _count(jreg, name), _count(treg, name)
  jax_calls()
  port_calls()
  assert _count(jreg, name) - j0 == expect
  assert _count(treg, name) - t0 == expect


@pytest.mark.parametrize('kw', [dict(strategy='block'),
                                dict(padded_window=8),
                                dict(with_weight=True)])
@pytest.mark.parametrize('dedup', ['tree', 'merge'])
def test_other_backends_count_no_kernel_calls(kw, dedup):
  """The padded, block and weighted hops never route through the hop or
  level kernel, in either package (JAX refuses ``use_fused_hop`` with
  them): neither kernel-path counter moves."""
  ei, n, rng = _graph()
  w = (rng.integers(1, 8, ei.shape[1]) / 2).astype(np.float32)
  jg = glt.data.Graph(glt.data.Topology(ei, edge_weights=w, num_nodes=n),
                      'CPU')
  tg = gtt.data.Graph(gtt.data.Topology(ei, num_nodes=n, edge_weights=w),
                      device='cpu')
  js = glt.sampler.NeighborSampler(jg, [3, 2], seed=1, dedup=dedup, **kw)
  ts = gtt.sampler.NeighborSampler(tg, [3, 2], seed=1, dedup=dedup,
                                   device='cpu', **kw)
  jreg, treg = jmetrics.default_registry(), metrics.default_registry()
  names = ('ops.fused_hop_calls', 'ops.fused_level_calls')
  before = [(_count(jreg, c), _count(treg, c)) for c in names]
  for _ in range(2):
    seeds = rng.integers(0, n, 8)
    js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds))
    ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds))
  after = [(_count(jreg, c), _count(treg, c)) for c in names]
  assert after == before


def test_negative_sample_launch_counter_stays_0_on_the_cpu():
  """The kernel's launch counter moves only where the kernel launches:
  CPU tensors take the plain version, so three link batches and a
  direct call leave it at 0."""
  ops.reset_launch_counts()
  _, port_calls = _link_calls('merge')
  port_calls()
  ei, n, _ = _graph()
  topo = gtt.data.Topology(ei, num_nodes=n)
  sorted_idx, _ = ops.sort_csr_segments(topo.indptr, topo.indices)
  ops.random_negative_sample(
      torch.as_tensor(topo.indptr.astype(np.int32)),
      torch.as_tensor(sorted_idx.astype(np.int32)), n, n, 8,
      gtt.random.PRNGKey(0))
  counts = ops.launch_counts()
  assert counts['negative_sample'] == 0
  assert all(v == 0 for v in counts.values()), counts
