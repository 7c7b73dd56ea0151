"""The port's public names against the JAX package's.

For every module of the port that has a counterpart in
``graphlearn_tpu`` (``benchmarks`` and ``examples`` aside), each public
name the JAX module defines (a top-level ``def``, ``class`` or
assignment) or, for a package's ``__init__``, re-exports from within the
package, must be reachable on the port's module. What the port leaves
out on purpose is listed below by name with its reason; a listed name
the port now has fails too, so the list stays true. The distributed
path's and ``utils``' namespaces are compared like the others: what
their later slices bring is listed, so no slice drops a name unnoticed.
"""
import ast
import importlib
import os
import pkgutil

import pytest
import torch

import graphlearn_tpu_torch as gtt

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, 'graphlearn_tpu')

FLAX = 'flax-only: freezes dicts into flax module attributes'
BLOCKS128 = ('blocks128 is refused: the port reads the flat indices, so '
             "the TPU's 128-lane layout has no counterpart")
XLA_COST = ("JAX-only: reads XLA's cost and memory analysis of a compiled "
            'program, which a CUDA graph capture does not carry')
JAX_ONLY = 'JAX-only: compilation cache, jax device placement, shard_map'

ABSENT = {
    # the GLT_PROGRAM_COST near-tie margin: the port's tie-break is the
    # wall, since a capture carries no XLA cost analysis
    ('tune.tuner', 'COST_TIE_MARGIN'): XLA_COST,
    ('models.models', 'freeze_etype_items'): FLAX,
    ('models.models', 'thaw_etype_items'): FLAX,
    ('ops', 'LEVEL_MAX_CANDIDATES'): BLOCKS128,
    ('ops', 'build_indices128'): BLOCKS128,
    ('ops.sample_fused', 'LANES'): BLOCKS128,
    ('ops.sample_fused', 'LEVEL_MAX_CANDIDATES'): BLOCKS128,
    ('ops.sample_fused', 'build_indices128'): BLOCKS128,
    ('sampler.neighbor_sampler', 'ops_ptr2ind'): (
        "a host copy of ptr2ind inside JAX's sampler; the port calls "
        'utils.ptr2ind'),
}
for _n in ('COST_ENV', 'capture_cost', 'cost_enabled'):
  ABSENT[('metrics.programs', _n)] = XLA_COST
for _n in ('shard_map', 'enable_compilation_cache', 'ensure_device',
           'get_available_device', 'global_device_put'):
  ABSENT[('utils', _n)] = JAX_ONLY


# What JAX does that has no counterpart in the port, beyond names: the
# JAX call, the module that makes it, and why the port leaves it out.
JAX_ONLY_CALLS = {
    ('utils.strict', 'checking_leaks'): (
        "jax.checking_leaks has no torch counterpart: no tracer can escape "
        'an eager or captured step; the port\'s guard is the card\'s sync '
        "debug mode ('error'), JAX's transfer_guard('disallow')"),
    ('tune.tuner', 'cost_enabled'): XLA_COST + (
        ': the GLT_PROGRAM_COST near-tie break; the port\'s tie-break is '
        'always the wall'),
    ('tune.topology', 'cost_enabled'): XLA_COST,
}


# JAX's analysis rules with no counterpart in the port's analyzer
# (graphlearn_tpu_torch/analysis): the rule, the JAX module that holds
# it, and why the port leaves it out.
JAX_ONLY_RULES = {
    'compat-shard-map': ('compat_import', (
        'the port has no utils/compat.py and no shard_map: its mesh is '
        'torch.distributed or a one-process view, not a jax transform')),
    'donation-safety': ('donation', (
        'torch does not donate buffers: no argument is dead after a '
        'call, so no read after one is stale')),
    'retrace-hazard': ('retrace', (
        'a torch call has no static arguments to retrace on; a shape '
        'change costs a CUDA graph recapture, which '
        'metrics/programs.retrace_budget counts at run time')),
}

def _jax_file(name):
  """The JAX module file of the port module ``name`` (relative, '' for
  the package), or None."""
  rel = name.replace('.', os.sep)
  for path in (os.path.join(JAX_ROOT, rel + '.py'),
               os.path.join(JAX_ROOT, rel, '__init__.py')):
    if os.path.isfile(path):
      return path
  return None


def jax_public(path):
  """The public names a JAX module defines, and for a package's
  ``__init__`` also those it imports from within the package."""
  pkg = os.path.basename(path) == '__init__.py'
  names = []
  for node in ast.parse(open(path).read()).body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      names.append(node.name)
    elif isinstance(node, ast.Assign):
      for t in node.targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        names += [e.id for e in elts if isinstance(e, ast.Name)]
    elif isinstance(node, ast.AnnAssign) and \
        isinstance(node.target, ast.Name):
      names.append(node.target.id)
    elif pkg and isinstance(node, ast.ImportFrom) and node.level > 0:
      names += [a.asname or a.name for a in node.names]
  return sorted({n for n in names if not n.startswith('_')})


def _port_modules():
  out = ['']
  for info in pkgutil.walk_packages(gtt.__path__, 'graphlearn_tpu_torch.'):
    name = info.name[len('graphlearn_tpu_torch.'):]
    if name.split('.')[0] not in ('benchmarks', 'examples'):
      out.append(name)
  return [m for m in out if _jax_file(m) is not None]


MODULES = _port_modules()


def _port(name):
  return importlib.import_module(
      'graphlearn_tpu_torch' + ('.' + name if name else ''))


@pytest.mark.parametrize('name', MODULES)
def test_module_namespace_matches_jax(name):
  mod = _port(name)
  missing = [n for n in jax_public(_jax_file(name))
             if not hasattr(mod, n) and (name, n) not in ABSENT]
  assert not missing, f'{name or "graphlearn_tpu_torch"} lacks {missing}'


def test_compared_set_covers_the_new_namespaces():
  for name in ('distributed', 'distributed.dist_context',
               'distributed.dist_graph', 'distributed.dist_feature',
               'distributed.dist_neighbor_sampler',
               'distributed.dist_dataset', 'distributed.dist_loader',
               'distributed.dist_random_partitioner',
               'distributed.dist_table_dataset', 'distributed.dist_options',
               'distributed.dist_sampling_producer', 'distributed.message',
               'distributed.rpc', 'distributed.resilience',
               'distributed.event_loop', 'distributed.dist_server',
               'distributed.dist_client', 'distributed.tenancy',
               'distributed.block_producer', 'distributed.remote_scan',
               'channel', 'channel.base',
               'channel.shm_channel', 'channel.mp_channel',
               'channel.remote_channel', 'utils.faults', 'utils.trace',
               'utils.build',
               'utils', 'utils.checkpoint', 'utils.common', 'utils.topo',
               'ops.route', 'ops.stitch', 'sampler.capacity',
               'recovery.failover', 'loader.scan_epoch',
               'loader.pipeline', 'metrics', 'metrics.flight',
               'metrics.spans', 'metrics.programs', 'metrics.scrape',
               'metrics.logcheck', 'metrics.registry_names'):
    assert name in MODULES, name


def test_every_listed_absence_is_live_and_has_a_reason():
  for (name, n), why in ABSENT.items():
    assert why, (name, n)
    path = _jax_file(name)
    assert path is not None, name
    assert n in jax_public(path), (name, n, 'not a JAX name')
    assert not hasattr(_port(name), n), (name, n, 'the port has it now')


def test_every_jax_only_call_is_live_and_has_a_reason():
  """JAX's module makes the call; the port's counterpart does not."""
  for (name, call), why in JAX_ONLY_CALLS.items():
    assert why, (name, call)
    src = open(_jax_file(name)).read()
    assert f'{call}(' in src, (name, call, 'JAX no longer calls it')
    port = importlib.import_module(f'graphlearn_tpu_torch.{name}')
    assert f'{call}(' not in open(port.__file__).read(), (name, call)


def test_compared_set_covers_the_tune_and_strict_modules():
  for name in ('tune', 'tune.artifact', 'tune.probes', 'tune.tuner',
               'tune.topology', 'tune.retune', 'utils.strict'):
    assert name in MODULES, name


def test_c10_names_are_reachable():
  assert gtt.ScanTrainer and gtt.RunTrainer and gtt.OverlappedTrainer
  from graphlearn_tpu_torch import (models, ops, recovery, sampler,
                                    typing)
  for mod, names in (
      (sampler, ('BaseSampler', 'estimate_frontier_caps',
                 'check_no_overflow', 'link_seed_width')),
      (models, ('TrainState', 'batch_to_dict', 'create_train_state',
                'make_train_step', 'tree_hop_offsets', 'merge_hop_offsets',
                'segment_mean_agg', 'segment_sum_agg', 'segment_max_agg')),
      (ops, ('stack2', 'stack2_batched', 'valid_mask',
             'searchsorted_membership')),
      (recovery, ('write_snapshot', 'load_snapshot', 'list_snapshots')),
      (typing, ('InputNodes', 'InputEdges'))):
    for n in names:
      assert hasattr(mod, n), (mod.__name__, n)


def test_base_sampler_refuses_another_samplers_state():
  s = gtt.sampler.BaseSampler()
  assert s.state_dict() == {}
  s.load_state_dict({})
  with pytest.raises(ValueError, match='different sampler type'):
    s.load_state_dict({'call_count': 3})
  for call in (s.sample_from_nodes, s.sample_from_edges, s.subgraph):
    with pytest.raises(NotImplementedError):
      call(None)


def test_every_jax_only_rule_is_live_and_has_a_reason():
  """Each JAX rule is ported or listed here; a listed rule is JAX's, has
  no module in the port, and the port's analyzer names it with why."""
  from graphlearn_tpu.analysis import core as jcore
  from graphlearn_tpu_torch import analysis
  from graphlearn_tpu_torch.analysis import core
  assert set(core.PRAGMA_RULES) | set(JAX_ONLY_RULES) == \
      set(jcore.PRAGMA_RULES)
  for rule, (module, why) in JAX_ONLY_RULES.items():
    assert why and rule not in core.PRAGMA_RULES, rule
    tree = ast.parse(open(_jax_file(f'analysis.{module}')).read())
    assert any(isinstance(n, ast.Assign) and
               any(getattr(t, 'id', '') == 'RULE' for t in n.targets) and
               getattr(n.value, 'value', None) == rule
               for n in tree.body), (rule, module)
    assert f'analysis.{module}' not in MODULES, module
    assert rule in analysis.__doc__, rule


def test_compared_set_covers_the_analysis_modules():
  for name in ('analysis', 'analysis.core', 'analysis.astutil',
               'analysis.flow', 'analysis.brackets', 'analysis.dispatch',
               'analysis.fault_points', 'analysis.hetero_gates',
               'analysis.host_sync', 'analysis.lint', 'analysis.locks',
               'analysis.metric_names', 'analysis.prng',
               'analysis.span_names'):
    assert name in MODULES, name
