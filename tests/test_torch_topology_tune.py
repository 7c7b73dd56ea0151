"""The port's topology tuner (``graphlearn_tpu_torch.tune.topology``)
against the JAX package's (``tests/test_topology_tune.py``'s contracts).

Held exactly (tolerance 0): the default candidate field of each topology;
the feasibility screen's analytic numbers and rejections (the dist
exchange's MB, the tiered slab plan, the remote block frames' in-flight
MB) against the same quotas; the fanout helpers; the remote acceptor's
validation (topology, fanouts, batch size, tuned block knobs); and the
refusals (unknown topology, no ``make_scenario``, an all-infeasible
field, an unknown knob, a tiered store of another hot prefix). Then a
real ``tune(topology='dist')`` over the port's ``DistScanTrainer`` on a
2-shard CPU mesh (the 40-node ring of ``tests/test_torch_dist_scan.py``):
two candidates fielded through ``make_scenario``, zero steady captures
(the CPU runs its chunks eagerly), the artifact's fingerprint JAX's for
the same partitions, ``DistScanTrainer(config=)`` adopting it and a
local ``ScanTrainer`` refusing it; the budget ladder truncating loudly.
"""
import json

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.tune import topology as jtopo
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.tune import topology as ttopo

from test_torch_dist_scan import jax_loader, port_loader, port_model

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

FANOUTS = [2, 2]
TYPED = {('u', 'to', 'v'): [2, 2], ('v', 'back', 'u'): [1, 1]}


def _cands(mod, topology, cfg, exact):
  return [(c.name, c.knobs, c.chunk_k, c.exact_semantics)
          for c in mod.default_topology_candidates(topology, cfg, exact)]


@pytest.mark.parametrize('topology', ['dist', 'remote', 'tiered_dist'])
@pytest.mark.parametrize('exact', [False, True])
def test_default_fields_equal_jax(topology, exact):
  cfg = dict(hot_prefix_choices=[4, 16])
  assert _cands(ttopo, topology, cfg, exact) == \
      _cands(jtopo, topology, cfg, exact)


def test_field_refusals_equal_jax():
  for mod in (jtopo, ttopo):
    with pytest.raises(ValueError, match='hot_prefix_choices'):
      mod.default_topology_candidates('tiered_dist', {}, False)
    with pytest.raises(ValueError, match='no default candidate field'):
      mod.default_topology_candidates('local', {}, False)


SCREENS = [
    ('dist', dict(bucket_frac=2.0, split_ratio=0.25, wire_dtype='bf16'),
     dict(feat_dim=100, num_partitions=4)),
    ('dist', dict(bucket_frac=None, split_ratio=0.0, wire_dtype=None),
     dict(feat_dim=100, num_partitions=4, max_exchange_mb=0.5)),
    ('dist', dict(split_ratio=0.5), dict(num_partitions=2)),
    ('tiered_dist', dict(hot_prefix_rows=64),
     dict(feat_dim=16, num_partitions=2, rows_per_shard=256,
          max_slab_rows=1024)),
    ('tiered_dist', dict(hot_prefix_rows=8, bucket_frac=0.5),
     dict(feat_dim=16, num_partitions=2, rows_per_shard=256,
          max_slab_rows=64, request_width=100)),
    ('remote', dict(block_ahead=2, block_wire_dtype=None),
     dict(feat_dim=100)),
    ('remote', dict(block_ahead=3, block_wire_dtype='bf16'),
     dict(feat_dim=100, max_block_mb=1.0, node_cap=4000, edge_cap=9000)),
]


@pytest.mark.parametrize('topology,knobs,extra', SCREENS)
@pytest.mark.parametrize('fanouts', [[15, 10, 5], TYPED])
def test_feasibility_screen_equals_jax(topology, knobs, extra, fanouts):
  cfg = dict(fanouts=fanouts, batch_size=64, **extra)
  j = jtopo.screen_candidate(topology, jtopo.TopologyCandidate('c', knobs),
                             4, cfg)
  t = ttopo.screen_candidate(topology, ttopo.TopologyCandidate('c', knobs),
                             4, cfg)
  assert t == j


def test_screen_plan_fn_and_unknown_knob_equal_jax():
  cfg = dict(fanouts=FANOUTS, batch_size=8, feat_dim=4,
             plan_fn=lambda knobs, k: 37 * k + knobs['hot_prefix_rows'],
             max_slab_rows=128)
  for hot in (1, 200):
    knobs = dict(hot_prefix_rows=hot)
    assert ttopo.screen_candidate(
        'tiered_dist', ttopo.TopologyCandidate('p', knobs), 2, cfg) == \
        jtopo.screen_candidate('tiered_dist',
                               jtopo.TopologyCandidate('p', knobs), 2, cfg)
  for mod in (jtopo, ttopo):
    with pytest.raises(ValueError, match='outside the'):
      mod.screen_candidate('remote', mod.TopologyCandidate(
          'x', dict(bucket_frac=1.0)), 2, cfg)


@pytest.mark.parametrize('fanouts', [[3, 2, 1], TYPED])
def test_fanout_helpers_equal_jax(fanouts):
  assert ttopo._choice_fanouts(fanouts) == jtopo._choice_fanouts(fanouts)
  assert ttopo._flatten_fanouts(fanouts) == jtopo._flatten_fanouts(fanouts)
  assert ttopo._node_budget(fanouts, 16) == jtopo._node_budget(fanouts, 16)
  assert ttopo.TOPOLOGY_SITES == jtopo.TOPOLOGY_SITES
  assert ttopo.TOPOLOGY_KNOBS == jtopo.TOPOLOGY_KNOBS


def test_tune_topology_refusals_equal_jax():
  for pkg in (glt, gtt):
    with pytest.raises(ValueError, match='unknown tune topology'):
      pkg.tune.tune_topology('mesh', None, dict(fanouts=FANOUTS,
                                                batch_size=2))
    with pytest.raises(ValueError, match='make_scenario'):
      pkg.tune(None, dict(fanouts=FANOUTS, batch_size=2), topology='dist')
    with pytest.raises(ValueError, match="'fanouts' and 'batch_size'"):
      pkg.tune(None, dict(make_scenario=lambda k, c: None), topology='dist')
    with pytest.raises(RuntimeError, match='every candidate screened'):
      pkg.tune(None, dict(fanouts=FANOUTS, batch_size=2, feat_dim=4,
                          num_partitions=2, max_exchange_mb=1e-9,
                          epoch_steps=4,
                          make_scenario=lambda k, c: None),
               topology='dist')


def _remote_art(pkg, **choices):
  base = dict(chunk_k=4, fanouts=FANOUTS, batch_size=4)
  base.update(choices)
  return pkg.tune.TuneArtifact(base, dict(num_nodes=38))


def test_remote_acceptor_equals_jax():
  from graphlearn_tpu.distributed import remote_scan as jrs
  from graphlearn_tpu_torch.distributed import remote_scan as trs
  ok = [dict(), dict(topology='remote', block_ahead=3,
                     block_wire_dtype='bf16')]
  for choices in ok:
    with pytest.warns(RuntimeWarning, match='holds no dataset'):
      j = jrs._resolve_remote_config('R', _remote_art(glt, **choices),
                                     FANOUTS, 4)
    with pytest.warns(RuntimeWarning, match='holds no dataset'):
      t = trs._resolve_remote_config('R', _remote_art(gtt, **choices),
                                     FANOUTS, 4)
    assert t == j
  assert trs._resolve_remote_config('R', None, FANOUTS, 4) == {}
  for choices, args, match in (
      (dict(topology='dist'), (FANOUTS, 4), "tuned for topology 'dist'"),
      (dict(), ([3, 3], 4), 'pins fanouts'),
      (dict(), (FANOUTS, 8), 'pins batch_size')):
    with pytest.raises(ValueError, match=match):
      jrs._resolve_remote_config('R', _remote_art(glt, **choices), *args)
    with pytest.raises(ValueError, match=match):
      trs._resolve_remote_config('R', _remote_art(gtt, **choices), *args)
  assert trs._norm_fans(TYPED) == jrs._norm_fans(TYPED)


def test_tiered_store_of_another_hot_prefix_is_refused(tmp_path):
  from test_torch_dist_hetero import _tiered_loader, port_rgnn
  loader = _tiered_loader(str(tmp_path), hot=4)
  fp = gtt.tune.dataset_fingerprint(loader.data)
  art = gtt.tune.TuneArtifact(dict(chunk_k=2, topology='tiered_dist',
                                   hot_prefix_rows=8), fp)
  with pytest.raises(ValueError, match='pins hot_prefix_rows=8'):
    gtt.storage.TieredDistScanTrainer(loader, port_rgnn(), 3, config=art)
  ok = gtt.tune.TuneArtifact(dict(chunk_k=2, topology='tiered_dist',
                                  hot_prefix_rows=4), fp)
  tr = gtt.storage.TieredDistScanTrainer(loader, port_rgnn(), 3, config=ok)
  assert tr.chunk_size == 2
  for st in tr._stagers.values():
    st.close()
  with pytest.raises(ValueError, match="tuned for topology 'tiered_dist'"):
    gtt.loader.DistScanTrainer(_tiered_loader(), port_rgnn(), 3, config=ok)


SEEDS = np.arange(16)   # 2 shards x batch 2: 4 steps an epoch


def _make_scenario(knobs, chunk_k):
  loader = port_loader(2, SEEDS, feature_kw=dict(
      split_ratio=knobs.get('split_ratio') or 0.0,
      bucket_frac=knobs.get('bucket_frac'),
      wire_dtype=knobs.get('wire_dtype')),
      bucket_frac=knobs.get('bucket_frac'))
  model = port_model()
  return (gtt.loader.DistScanTrainer(loader, model, 3, chunk_size=chunk_k),
          ttrain.create_train_state(model))


def _dist_cfg(**kw):
  cfg = dict(fanouts=FANOUTS, batch_size=2, epoch_steps=4,
             make_scenario=_make_scenario, feat_dim=4, num_partitions=2)
  cfg.update(kw)
  return cfg


def test_dist_topology_tune_and_config_accept(tmp_path):
  ds = port_loader(2, SEEDS).data
  art = gtt.tune(ds, _dist_cfg(), topology='dist', exact=True,
                 out_path=str(tmp_path / 'dist.json'))
  assert art.topology == 'dist' and art.choices['chunk_k'] == 4
  recs = [e for e in art.evidence if e.get('kind') == 'candidate']
  assert [r['name'] for r in recs] == ['dist_fullwidth', 'dist_bucketed']
  for r in recs:
    assert r['qualified'], r
    assert set(r['steady_epoch_compiles']) == set(
        ttopo.TOPOLOGY_SITES['dist'])
    assert sum(r['steady_epoch_compiles'].values()) == 0
  feas = [e for e in art.evidence if e.get('kind') == 'feasibility']
  jd = jax_loader(2, SEEDS).data
  jfeas = [jtopo.screen_candidate('dist', jtopo.TopologyCandidate(
      c.name, c.knobs), 4, _dist_cfg()) for c in
      jtopo.default_topology_candidates('dist', {}, True)]
  assert feas == [ev for _, ev in jfeas]
  # the JSON validates against JAX's dataset of the same partitions
  j = glt.tune.TuneArtifact.load(str(tmp_path / 'dist.json'))
  j.validate_dataset(jd)
  assert art.dataset['num_partitions'] == 2
  # the matching trainer adopts it, the local one refuses it
  trainer, _ = _make_scenario(art.topology_kwargs(), 2)
  tr = gtt.loader.DistScanTrainer(port_loader(2, SEEDS), port_model(), 3,
                                  config=art)
  assert tr.chunk_size == 4
  del trainer
  local = gtt.data.Dataset(device='cpu')
  local.init_graph(np.stack([np.arange(8), (np.arange(8) + 1) % 8]),
                   num_nodes=8)
  local.init_node_features(np.ones((8, 4), np.float32))
  local.init_node_labels(np.arange(8) % 3)
  loader = gtt.loader.NeighborLoader(local, FANOUTS, np.arange(8),
                                     device='cpu')
  with pytest.raises(ValueError, match="tuned for topology 'dist'"):
    gtt.loader.ScanTrainer(loader, port_model(), 3, config=art)
  assert json.load(open(tmp_path / 'dist.json'))['choices']['topology'] \
      == 'dist'


def test_budget_ladder_truncates_loudly():
  ds = port_loader(2, SEEDS).data
  art = gtt.tune(ds, _dist_cfg(), topology='dist', budget_s=1e-9)
  bud = [e for e in art.evidence if e.get('kind') == 'budget']
  assert len(bud) == 1 and bud[0]['kept'] == []
  assert bud[0]['dropped'] == ['dist_bucketed', 'dist_bucketed_bf16']
  recs = [e for e in art.evidence if e.get('kind') == 'candidate']
  assert [r['name'] for r in recs] == ['dist_fullwidth']
