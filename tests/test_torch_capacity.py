"""The port's ``CapacityPlan`` against the JAX package's.

Mirrors the plan-class part of ``tests/test_capacity_plans.py`` (``:76``
to ``:160``): the homogeneous degenerate plan (one node type, one
implicit edge type, one key draw a batch) and the typed plan over the
port's ``hetero_capacity_plan``, each field, derived view (out-facing
edge types and caps, frame keys, block and slab budgets, the engine
triple) and the JSON-stable fingerprint payload equal to JAX's for the
same inputs; ``from_sampler`` on a typed and an untyped sampler of each
package; ``CapacityPlanError``'s message; ``ack_edge_ids`` on a link
and a node frame.
"""
import json

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.sampler import capacity as jcap
from graphlearn_tpu_torch.sampler import capacity as tcap

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

UB, BU = ('user', 'buys', 'item'), ('item', 'rev_buys', 'user')
NU, NI, BS = 18, 12, 4
FANOUTS = {UB: [2, 2], BU: [2, 2]}


def assert_plans_equal(jp, tp):
  for f in ('ntypes', 'etypes', 'edge_dir', 'seed_caps', 'hop_caps',
            'node_caps', 'input_type', 'wire_dtype', 'metadata'):
    assert getattr(tp, f) == getattr(jp, f), f
  for prop in ('num_hops', 'is_hetero', 'batch_cap', 'edge_caps',
               'key_draws_per_batch'):
    assert getattr(tp, prop) == getattr(jp, prop), prop
  assert tp.out_etypes() == jp.out_etypes()
  assert tp.feat_types() == jp.feat_types()
  assert tp.frame_keys() == jp.frame_keys()
  dims = {t: 4 for t in jp.ntypes}
  assert tp.block_mb_per_chunk(3, dims) == jp.block_mb_per_chunk(3, dims)
  hot = {t: 2 for t in jp.ntypes}
  assert tp.slab_caps_upper(hot, 3) == jp.slab_caps_upper(hot, 3)
  assert tp.engine_plan() == jp.engine_plan()
  payload = tp.fingerprint_payload()
  assert payload == jp.fingerprint_payload()
  assert json.loads(json.dumps(payload)) == payload


@pytest.mark.parametrize('b,fanouts,kw', [
    (8, [2, 2], {}), (16, [15, 10, 5], dict(node_budget=600)),
    (8, [3, 2], dict(frontier_caps=[8, 12], wire_dtype='bf16'))])
def test_homo_plan_equals_jax(b, fanouts, kw):
  tp = tcap.CapacityPlan.homo(b, fanouts, **kw)
  jp = jcap.CapacityPlan.homo(b, fanouts, **kw)
  assert tp.ntypes == (tcap.DEFAULT_NTYPE,) and not tp.is_hetero
  assert tp.key_draws_per_batch == 1
  caps = gtt.sampler.capacity_plan(b, fanouts, kw.get('node_budget'),
                                   kw.get('frontier_caps'))
  assert tp.node_caps[tcap.DEFAULT_NTYPE] == sum(caps)
  assert tp.frame_keys()[:2] == ['node', 'num_nodes']
  assert_plans_equal(jp, tp)


@pytest.mark.parametrize('edge_dir,caps', [('out', None),
                                           ('in', {UB: [4, 6]})])
def test_hetero_plan_equals_jax(edge_dir, caps):
  args = ([UB, BU], FANOUTS, {'user': BS}, edge_dir)
  tp = tcap.CapacityPlan.hetero(*args, etype_caps=caps, input_type='user')
  jp = jcap.CapacityPlan.hetero(*args, etype_caps=caps, input_type='user')
  assert tp.is_hetero and set(tp.ntypes) == {'user', 'item'}
  assert tp.key_draws_per_batch == sum(len(h) for h in tp.hop_caps) >= 2
  keys = tp.frame_keys()
  assert '#META.hetero' in keys and 'x.user' in keys and 'y.user' in keys
  # the accessor form and the dict form give one plan
  fan = lambda et: FANOUTS[tuple(et)]  # noqa: E731
  assert tcap.CapacityPlan.hetero([UB, BU], fan, {'user': BS}, edge_dir,
                                  etype_caps=caps, input_type='user') == tp
  assert_plans_equal(jp, tp)


def _typed_datasets():
  rng = np.random.default_rng(0)
  ub = np.stack([rng.integers(0, NU, 40), rng.integers(0, NI, 40)])
  graph = {UB: ub, BU: ub[::-1].copy()}
  nodes = {UB: NU, BU: NI}
  tds = gtt.data.Dataset(edge_dir='out', device='cpu')
  tds.init_graph(graph, num_nodes=nodes)
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(graph, graph_mode='CPU', num_nodes=nodes)
  return jds, tds


def test_from_sampler_equals_jax_and_names_a_missing_input_type():
  jds, tds = _typed_datasets()
  js = glt.sampler.NeighborSampler(jds.graph, FANOUTS)
  ts = gtt.sampler.NeighborSampler(tds.graph, FANOUTS, device='cpu')
  with pytest.raises(tcap.CapacityPlanError) as ei:
    tcap.CapacityPlan.from_sampler(ts, BS)
  assert ei.value.consumer == 'CapacityPlan.from_sampler'
  assert 'docs/capacity_plans.md' in str(ei.value)
  assert_plans_equal(jcap.CapacityPlan.from_sampler(js, BS,
                                                    input_type='user'),
                     tcap.CapacityPlan.from_sampler(ts, BS,
                                                    input_type='user'))
  rows = np.arange(NU)
  ei = np.stack([rows, (rows + 1) % NU])
  hj = glt.data.Dataset()
  hj.init_graph(ei, graph_mode='CPU', num_nodes=NU)
  ht = gtt.data.Dataset(device='cpu')
  ht.init_graph(ei, num_nodes=NU)
  assert_plans_equal(
      jcap.CapacityPlan.from_sampler(
          glt.sampler.NeighborSampler(hj.graph, [3, 2]), 8),
      tcap.CapacityPlan.from_sampler(
          gtt.sampler.NeighborSampler(ht.graph, [3, 2], device='cpu'), 8))


def test_error_is_a_value_error_with_jax_message():
  t = tcap.CapacityPlanError('Consumer', 'thing is missing', hint='do X')
  j = jcap.CapacityPlanError('Consumer', 'thing is missing', hint='do X')
  assert isinstance(t, ValueError) and str(t) == str(j)
  assert (t.consumer, t.missing) == ('Consumer', 'thing is missing')
  assert gtt.sampler.CapacityPlanError is tcap.CapacityPlanError
  assert gtt.sampler.DEFAULT_ETYPE == jcap.DEFAULT_ETYPE
  assert gtt.sampler.DEFAULT_NTYPE == jcap.DEFAULT_NTYPE


def test_ack_edge_ids_reads_block_provenance():
  eb = np.arange(2 * 2 * 5).reshape(2, 2, 5)
  frame = {'#META.edge_batch': eb,
           '#META.edge_batch_size': np.array([[5], [3]])}
  for step, n in ((0, 5), (1, 3)):
    got = gtt.sampler.ack_edge_ids(frame, step)
    np.testing.assert_array_equal(got, jcap.ack_edge_ids(frame, step))
    assert got.shape == (2, n)
  assert gtt.sampler.ack_edge_ids({'batch': np.zeros(3)}, 0) is None
