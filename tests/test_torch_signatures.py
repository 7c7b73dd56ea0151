"""The port's public calls against the JAX package's.

``inspect.signature`` of every public class and function of
``graphlearn_tpu.data``, of the loaders, of ``SamplerOutput``, of the
typed names (the ``typing`` helpers, ``HeteroSamplerOutput``,
``HeteroData``, ``to_hetero_data``, the typed plan, layout, block and
calibration functions, the typed models ``GATConv``, ``HeteroConv``,
``TreeHeteroConv``, ``RGNN``, ``HGTConv`` and ``HGT``, and the
homogeneous ``GCNConv``, ``TreeGATConv``, ``MergeGATConv``, ``GCN`` and
``GAT``, flax's ``parent`` / ``name`` aside, and ``run_impl_decision``),
of the ``graphlearn_tpu.storage`` API (single-device and distributed),
of the distributed trainers, failover, ``CapacityPlan`` and the sharded
serving stores, of the serving
stack's spill (``EmbeddingMaterializer(spill_dir=)``,
``tiered_embedding_store``, ``TieredEmbeddingStore``,
``warm_embedding_store``) and typed refresh (``refresh_rows(ids,
ntype=)``, ``make_layer_slice_fn(..., **fixed)``), of the link sampling
entry points (``sample_from_edges``, the typed
``_hetero_sample_from_edges``, ``sample_prob``) and of ``partition``
(its classes, functions and the partition containers) against the
port's: the same parameter names, in the
same order, of the same kinds, with the same defaults (annotations are
not compared). The port's deliberate differences are listed by name
below (``ROADMAP.md``, "Deliberate divergences"); any other difference
fails. Then JAX's calls run on the port: ``Topology`` from CSR and CSC
input, ``degree`` / ``to_coo`` / ``to_csc``, every graph mode,
``Dataset.init_graph`` with JAX's positional order, the ``Dataset``
accessors, the loaders' ``to_device`` and ``collect_features`` and
``SamplerOutput.trim``, each equal to JAX's.
"""
import inspect

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

CPU = 'cpu'

# (qualified name, parameter) -> why the port differs
EXTRA_PARAMS = {
    # every tensor of a port Dataset is placed at init, on this device
    # (None means the card); JAX places lazily on its default device
    ('Dataset', 'device'): 'the port places the dataset at init',
    # the port's spelling of JAX's to_device, kept as a keyword alias
    ('NodeLoader', 'device'): 'device= alias of to_device',
    ('NeighborLoader', 'device'): 'device= alias of to_device',
    ('LinkLoader', 'device'): 'device= alias of to_device',
    ('LinkNeighborLoader', 'device'): 'device= alias of to_device',
    ('SubGraphLoader', 'device'): 'device= alias of to_device',
    # a CUDA graph per chunk length, as the port's ScanTrainer
    ('TieredScanTrainer', 'capture'): 'captured chunks (ScanTrainer)',
    # the slot of a slab is handed back once its copy's event completed
    ('ChunkStager.ack', 'event'): 'the slab copy\'s CUDA event',
    # entry points run on the card unless the caller asks for the CPU
    ('warm_embedding_store', 'device'): 'the store\'s device',
    # the process's own device (NCCL on a card, gloo on the CPU); JAX
    # takes the process's devices from its runtime
    ('init_multihost', 'device'): 'this process\'s torch device',
    # a CUDA graph per chunk length, as the port's ScanTrainer
    ('DistScanTrainer', 'capture'): 'captured chunks (ScanTrainer)',
    ('TieredDistScanTrainer', 'capture'): 'captured chunks (ScanTrainer)',
    ('RotatingShardedStore', 'device'): 'where lookups return their rows',
    # where the mp and remote loaders' batches go (mp: the dataset's
    # device by default; remote: the card), and where message_to_data
    # uploads (to_device=True)
    ('MpDistNeighborLoader', 'device'): 'where the batches go',
    ('MpDistLinkNeighborLoader', 'device'): 'where the batches go',
    ('RemoteDistNeighborLoader', 'device'): 'where the batches go',
    ('RemoteDistLinkNeighborLoader', 'device'): 'where the batches go',
    ('message_to_data', 'device'): 'where the batch is uploaded',
    # where the model trains (the card unless the caller asks for the
    # CPU), then a CUDA graph per chunk length, as the port's ScanTrainer
    ('RemoteScanTrainer', 'device'): 'where the model trains',
    ('RemoteScanTrainer', 'capture'): 'captured chunks (ScanTrainer)',
    # the stager packs each frame into a pinned slot, made once
    ('RemoteBlockStager', 'pack_fn'): 'packs a frame into a slot',
    ('RemoteBlockStager', 'slot_bytes_fn'): 'sizes the slots once',
    ('RemoteBlockStager', 'pin'): 'pinned slots on a card',
    # a slot is handed back once its upload's event completed
    ('RemoteBlockStager.ack', 'event'): 'the upload\'s CUDA event',
}
MISSING_PARAMS = {
    # kernels route by device in the port (ROADMAP, deliberate divergences)
    ('NeighborLoader', 'use_fused_hop'): 'kernels route by device',
    ('NeighborLoader', 'fused_hop_window'): 'kernels route by device',
    # the optimizer lives in the port's TrainState, not beside the model
    ('TieredScanTrainer', 'tx'): 'Adam is in TrainState',
    # the port's models own their weights
    ('EmbeddingMaterializer', 'params'): 'the model owns its weights',
    ('DistFusedEpochTrainer', 'tx'): 'Adam is in TrainState',
    ('DistScanTrainer', 'tx'): 'Adam is in TrainState',
    ('TieredDistScanTrainer', 'tx'): 'Adam is in TrainState',
    ('RemoteScanTrainer', 'tx'): 'Adam is in TrainState',
}
# (qualified name, parameter) -> why the default differs
OTHER_DEFAULTS = {
    # the same member, of the port's own DistRole enum
    ('DistContext', 'role'): 'DistRole.WORKER of the port\'s enum',
    # the port routes its hop kernels by device: a fused-hop variant would
    # measure the base candidate again, so none is fielded by default
    ('kernel_candidates', 'fused_hop_windows'): 'hops route by device',
}
MISSING_MEMBERS = {
    # placed at init: instance attributes, not lazy properties
    ('Graph', 'indptr'): 'an instance attribute in the port',
    ('Graph', 'indices'): 'an instance attribute in the port',
    ('Graph', 'lazy_init'): 'the port places the CSR at init',
    # on a card the all-device lookup is always the row-gather kernel;
    # JAX opts into its Pallas kernel with this flag
    ('UnifiedTensor', 'use_pallas'): 'the kernel routes by device',
}


def _params(fn):
  return [(p.name, p.kind, p.default)
          for p in inspect.signature(fn).parameters.values()]


def _same_default(a, b):
  if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
    return a is b
  if isinstance(a, type) or isinstance(b, type):
    return a is b
  return type(a) is type(b) and a == b


def assert_same_signature(qual, jfn, tfn):
  jp = [p for p in _params(jfn) if (qual, p[0]) not in MISSING_PARAMS]
  tp = [p for p in _params(tfn) if (qual, p[0]) not in EXTRA_PARAMS]
  assert [p[0] for p in tp] == [p[0] for p in jp], qual
  for (name, jkind, jdef), (_, tkind, tdef) in zip(jp, tp):
    assert jkind == tkind, (qual, name)
    if (qual, name) in OTHER_DEFAULTS:
      assert not _same_default(jdef, tdef), (qual, name)
      continue
    assert _same_default(jdef, tdef), (qual, name, jdef, tdef)
  extras = [name for (q, name) in EXTRA_PARAMS if q == qual]
  if extras:
    tall = [p[0] for p in _params(tfn)]
    assert tall[-len(extras):] == extras, \
        (qual, 'the extra parameters go last, in their listed order')


def _public(mod):
  return sorted(n for n in getattr(mod, '__all__', dir(mod))
                if not n.startswith('_'))


def _compare_class(name, jcls, tcls):
  assert_same_signature(name, jcls.__init__, tcls.__init__)
  for member, v in vars(jcls).items():
    if member.startswith('_'):
      continue
    if (name, member) in MISSING_MEMBERS:
      assert not hasattr(tcls, member) or member in ('indptr', 'indices')
      continue
    assert hasattr(tcls, member), f'{name}.{member} is missing'
    if isinstance(v, (staticmethod, classmethod)):
      v = v.__func__
    if inspect.isfunction(v):
      tv = inspect.getattr_static(tcls, member)
      if isinstance(tv, (staticmethod, classmethod)):
        tv = tv.__func__
      assert_same_signature(f'{name}.{member}', v, tv)


DATA_NAMES = _public(glt.data)


@pytest.mark.parametrize('name', DATA_NAMES)
def test_data_package_signatures(name):
  j = getattr(glt.data, name)
  assert hasattr(gtt.data, name), f'graphlearn_tpu_torch.data.{name}'
  t = getattr(gtt.data, name)
  if inspect.ismodule(j):
    for fn in _public(j):
      jf = getattr(j, fn)
      if inspect.isfunction(jf) and jf.__module__ == j.__name__:
        assert_same_signature(f'{name}.{fn}', jf, getattr(t, fn))
  elif inspect.isclass(j):
    _compare_class(name, j, t)
  else:
    assert_same_signature(name, j, t)


STORAGE_NAMES = _public(glt.storage)


@pytest.mark.parametrize('name', STORAGE_NAMES)
def test_storage_package_signatures(name):
  j = getattr(glt.storage, name)
  assert hasattr(gtt.storage, name), f'graphlearn_tpu_torch.storage.{name}'
  t = getattr(gtt.storage, name)
  if inspect.ismodule(j):
    for fn in _public(j):
      jf = getattr(j, fn)
      if inspect.isfunction(jf) and jf.__module__ == j.__name__:
        assert_same_signature(f'{name}.{fn}', jf, getattr(t, fn))
      elif inspect.isclass(jf) and jf.__module__ == j.__name__:
        _compare_class(fn, jf, getattr(t, fn))
  elif inspect.isclass(j):
    _compare_class(name, j, t)
  else:
    assert_same_signature(name, j, t)
  assert sorted(_public(gtt.storage)) == STORAGE_NAMES


def test_serving_dist_store_signatures():
  from graphlearn_tpu.serving import materialize as jmat
  assert_same_signature(
      'EmbeddingMaterializer.dist_embedding_store',
      jmat.EmbeddingMaterializer.dist_embedding_store,
      gtt.serving.EmbeddingMaterializer.dist_embedding_store)


def test_serving_spill_signatures():
  from graphlearn_tpu.serving import materialize as jmat
  from graphlearn_tpu.serving import store as jstore
  assert_same_signature('EmbeddingMaterializer',
                        jmat.EmbeddingMaterializer.__init__,
                        gtt.serving.EmbeddingMaterializer.__init__)
  assert_same_signature(
      'EmbeddingMaterializer.tiered_embedding_store',
      jmat.EmbeddingMaterializer.tiered_embedding_store,
      gtt.serving.EmbeddingMaterializer.tiered_embedding_store)
  assert_same_signature('warm_embedding_store', jmat.warm_embedding_store,
                        gtt.serving.warm_embedding_store)
  _compare_class('TieredEmbeddingStore', jstore.TieredEmbeddingStore,
                 gtt.serving.TieredEmbeddingStore)


LOADERS = ['NodeLoader', 'NeighborLoader', 'LinkLoader',
           'LinkNeighborLoader', 'SubGraphLoader']


@pytest.mark.parametrize('name', LOADERS)
def test_loader_signatures(name):
  _compare_class(name, getattr(glt.loader, name), getattr(gtt.loader, name))


@pytest.mark.parametrize('member', ['sample_from_edges',
                                    '_hetero_sample_from_edges',
                                    '_neg_sorted', 'sample_prob'])
def test_link_sampling_signatures(member):
  """The typed link sampling entry points and ``sample_prob``."""
  assert_same_signature(f'NeighborSampler.{member}',
                        getattr(glt.sampler.NeighborSampler, member),
                        getattr(gtt.sampler.NeighborSampler, member))


PARTITION_NAMES = ['PartitionerBase', 'RandomPartitioner',
                   'FrequencyPartitioner', 'load_partition',
                   'cat_feature_cache']


@pytest.mark.parametrize('name', PARTITION_NAMES)
def test_partition_signatures(name):
  """``partition``'s public classes (their methods too) and functions."""
  assert _public(gtt.partition) == _public(glt.partition) == sorted(
      PARTITION_NAMES + ['base', 'frequency_partitioner',
                         'random_partitioner'])
  j, t = getattr(glt.partition, name), getattr(gtt.partition, name)
  if inspect.isclass(j):
    _compare_class(name, j, t)
  else:
    assert_same_signature(name, j, t)


@pytest.mark.parametrize('name', ['GraphPartitionData',
                                  'FeaturePartitionData'])
def test_partition_container_signatures(name):
  j, t = getattr(glt.typing, name), getattr(gtt.typing, name)
  assert t._fields == j._fields and t._field_defaults == j._field_defaults


def test_serving_slice_and_refresh_signatures():
  """``make_layer_slice_fn(model, lo, hi, **fixed)`` and the typed
  ``refresh_rows(ids, ntype=None)``."""
  from graphlearn_tpu.models import train as jtrain
  from graphlearn_tpu.serving import materialize as jmat
  assert_same_signature('make_layer_slice_fn', jtrain.make_layer_slice_fn,
                        gtt.models.train.make_layer_slice_fn)
  assert_same_signature('EmbeddingMaterializer.refresh_rows',
                        jmat.EmbeddingMaterializer.refresh_rows,
                        gtt.serving.EmbeddingMaterializer.refresh_rows)
  for member in ('embedding_store', '_hetero_layout', '_hetero_live_for'):
    jp = [p[0] for p in _params(getattr(jmat.EmbeddingMaterializer,
                                        member))]
    tp = [p[0] for p in _params(getattr(gtt.serving.EmbeddingMaterializer,
                                        member))]
    assert tp[:len(jp)] == jp, member


def test_sampler_output_signature():
  _compare_class('SamplerOutput', glt.sampler.SamplerOutput,
                 gtt.sampler.SamplerOutput)


TYPED_FUNCTIONS = [
    ('typing', 'as_str'), ('typing', 'to_edge_type'),
    ('typing', 'reverse_edge_type'), ('typing', 'split_edge_type_seeds'),
    ('loader', 'to_hetero_data'),
    ('sampler', 'hetero_tree_layout'), ('sampler', 'hetero_tree_blocks'),
    ('sampler', 'estimate_hetero_frontier_caps'),
    ('sampler.neighbor_sampler', 'hetero_capacity_plan'),
    ('sampler.neighbor_sampler', '_final_touch_map'),
    ('sampler.calibrate', 'normalize_hetero_frontier_caps'),
    ('sampler.calibrate', 'clamp_etype_cap'),
]


def _attr(pkg, dotted):
  for part in dotted.split('.'):
    pkg = getattr(pkg, part)
  return pkg


@pytest.mark.parametrize('mod,name', TYPED_FUNCTIONS)
def test_typed_function_signatures(mod, name):
  assert_same_signature(name, getattr(_attr(glt, mod), name),
                        getattr(_attr(gtt, mod), name))


@pytest.mark.parametrize('mod,name', [('sampler', 'HeteroSamplerOutput'),
                                      ('loader', 'HeteroData')])
def test_typed_container_signatures(mod, name):
  _compare_class(name, getattr(_attr(glt, mod), name),
                 getattr(_attr(gtt, mod), name))


# (model, parameter) -> why the port's torch module differs from the flax
# one: torch builds its weights at construction, so it needs their input
# widths (and the types a dense layer's input holds) up front, and it
# places and draws them (device, generator); dropout is the module's
# train() mode, not a call argument
MODEL_EXTRA = {
    ('GATConv', 'in_dim'): 'torch builds the weights at init',
    ('TreeHeteroConv', 'in_dim'): 'torch builds the weights at init',
    ('TreeHeteroConv', 'in_types'): 'the layer\'s input types, at init',
    ('RGNN', 'in_dims'): 'torch builds the embeddings at init',
    ('RGNN', 'device'): 'entry points run on the card',
    ('RGNN', 'generator'): 'the seed of the initial weights',
    ('GCNConv', 'in_dim'): 'torch builds the weights at init',
    ('TreeGATConv', 'in_dim'): 'torch builds the weights at init',
    ('MergeGATConv', 'in_dim'): 'torch builds the weights at init',
    ('GCN', 'in_dim'): 'torch builds the weights at init',
    ('GCN', 'device'): 'entry points run on the card',
    ('GCN', 'generator'): 'the seed of the initial weights',
    ('GAT', 'in_dim'): 'torch builds the weights at init',
    ('GAT', 'device'): 'entry points run on the card',
    ('GAT', 'generator'): 'the seed of the initial weights',
    # HGT keeps JAX's in_dims (same place, same default) but requires it
    ('HGT', 'device'): 'entry points run on the card',
    ('HGT', 'generator'): 'the seed of the initial weights',
}
MODEL_MISSING = {
    ('RGNN.__call__', 'train'): 'nn.Module.train() mode',
    # dropout > 0 draws from torch's stream in train() mode (JAX: flax's
    # 'dropout' rng with train=True)
    ('GCN.__call__', 'train'): 'nn.Module.train() mode',
    ('GAT.__call__', 'train'): 'nn.Module.train() mode',
    ('HGT.__call__', 'train'): 'nn.Module.train() mode',
}
TYPED_MODELS = ['GATConv', 'HeteroConv', 'TreeHeteroConv', 'RGNN',
                'HGTConv', 'HGT', 'GCNConv', 'TreeGATConv', 'MergeGATConv',
                'GCN', 'GAT']


def _model_fn(pkg, name, member):
  cls = getattr(pkg.models, name)
  if pkg is gtt:
    return getattr(cls, '__init__' if member == '__init__' else 'forward')
  return getattr(cls, member)


def _model_params(qual, fn, drop):
  return [p for p in _params(fn) if p[0] not in ('self', 'parent', 'name')
          and (qual, p[0]) not in drop]


def test_run_impl_decision_signature():
  assert_same_signature('run_impl_decision',
                        glt.models.models.run_impl_decision,
                        gtt.models.run_impl_decision)


@pytest.mark.parametrize('name', TYPED_MODELS)
def test_typed_model_signatures(name):
  """Each typed model's constructor and call (torch's ``forward``)
  against the flax module's fields and ``__call__``: the same names in
  the same order with the same defaults, the listed differences aside."""
  for member in ('__init__', '__call__'):
    qual = name if member == '__init__' else f'{name}.__call__'
    jp = _model_params(qual, _model_fn(glt, name, member), MODEL_MISSING)
    tp = _model_params(qual, _model_fn(gtt, name, member), MODEL_EXTRA)
    assert [p[0] for p in tp] == [p[0] for p in jp], qual
    for (pname, _, jdef), (_, _, tdef) in zip(jp, tp):
      assert _same_default(jdef, tdef), (qual, pname, jdef, tdef)


def test_every_named_difference_is_live():
  """A listed difference that no longer differs is struck from the list."""
  def port_fn(qual, pkg=gtt):
    head, _, member = qual.partition('.')
    for mod in (pkg.data, pkg.loader, pkg.storage, pkg.serving,
                pkg.distributed, pkg.tune):
      obj = getattr(mod, head, None)
      if obj is not None:
        obj = getattr(obj, member) if member else obj
        return obj.__init__ if inspect.isclass(obj) else obj
    raise AssertionError(qual)

  for (qual, param) in EXTRA_PARAMS:
    assert param in inspect.signature(port_fn(qual)).parameters
    assert param not in inspect.signature(port_fn(qual, glt)).parameters
  for (qual, param) in MISSING_PARAMS:
    assert param not in inspect.signature(port_fn(qual)).parameters
    assert param in inspect.signature(port_fn(qual, glt)).parameters
  for (qual, param) in OTHER_DEFAULTS:
    assert inspect.signature(port_fn(qual)).parameters[param].default != \
        inspect.signature(port_fn(qual, glt)).parameters[param].default
  for (qual, param) in MODEL_EXTRA:
    assert param in inspect.signature(_model_fn(gtt, qual, '__init__')
                                      ).parameters
    assert param not in inspect.signature(_model_fn(glt, qual, '__init__')
                                          ).parameters
  for (qual, param) in MODEL_MISSING:
    name = qual.split('.')[0]
    assert param not in inspect.signature(_model_fn(gtt, name, '__call__')
                                          ).parameters
    assert param in inspect.signature(_model_fn(glt, name, '__call__')
                                      ).parameters


# Deliberate differences of the distributed path that a signature does
# not show: ``init_worker_group(devices=)`` takes a torch device (the one
# device of every shard; JAX: a device list), ``mesh=`` everywhere is a
# ``ShardMesh`` (JAX: a ``jax.sharding.Mesh``; ``mesh_shape=(S, C)`` gives
# a ``ShardMesh`` of that ``shape``, JAX's ('slice', 'chip') mesh),
# ``DistFeature(dtype=, wire_dtype=)`` take torch dtypes (or names) and
# ``cpu_get`` returns a CPU tensor.
DIST_CLASSES = ['DistContext', 'DistGraph', 'DistHeteroGraph', 'DistFeature',
                'DistNeighborSampler', 'DistDataset', 'DistLoader',
                'DistNeighborLoader', 'DistLinkNeighborLoader',
                'DistSubGraphLoader']
DIST_FUNCTIONS = [
    ('distributed', 'init_worker_group'), ('distributed', 'init_multihost'),
    ('distributed', 'get_context'), ('distributed', 'build_local_csr'),
    ('distributed', 'shared_node_pb'),
    ('distributed.dist_feature', 'miss_capacity'),
    ('distributed.dist_feature', 'feature_exchange_mb'),
    ('ops', 'round8'), ('ops', 'exchange_capacity'), ('ops', 'route_slots'),
    ('ops', 'scatter_to_buckets'), ('ops', 'gather_from_buckets'),
    ('ops', 'stitch_rows'), ('ops', 'uniform_sample_local'),
    ('ops', 'weighted_sample_local'), ('ops', 'stack2'),
    ('ops', 'stack2_batched'), ('ops', 'valid_mask'),
    ('ops', 'searchsorted_membership'),
    ('ops', 'random_negative_sample_local'), ('ops', 'node_subgraph_local'),
    ('utils', 'coo_to_csr'), ('utils', 'coo_to_csc'), ('utils', 'csr_to_coo'),
    ('utils', 'csr_to_csc'), ('utils', 'ptr2ind'), ('utils', 'ind2ptr'),
    ('utils', 'count_dict'), ('utils', 'merge_dict'),
    ('utils', 'get_free_port'), ('utils', 'load_module'),
    ('utils', 'convert_to_array'), ('utils', 'id2idx'),
    ('utils', 'squeeze_dict'), ('utils', 'parse_size'),
    ('utils', 'format_size'), ('utils', 'python_exit_status'),
]


@pytest.mark.parametrize('name', DIST_CLASSES)
def test_distributed_class_signatures(name):
  """The distributed path's classes, their public methods too."""
  _compare_class(name, getattr(glt.distributed, name),
                 getattr(gtt.distributed, name))


@pytest.mark.parametrize('mod,name', DIST_FUNCTIONS)
def test_distributed_ops_and_utils_signatures(mod, name):
  assert_same_signature(name, getattr(_attr(glt, mod), name),
                        getattr(_attr(gtt, mod), name))


@pytest.mark.parametrize('name', ['CheckpointManager', 'BaseSampler'])
def test_checkpoint_manager_and_base_sampler_signatures(name):
  mod = 'utils' if name == 'CheckpointManager' else 'sampler'
  _compare_class(name, getattr(getattr(glt, mod), name),
                 getattr(getattr(gtt, mod), name))


# ----------------------------------------------- JAX's calls on the port


def _coo(n=30, e=90, seed=0):
  rng = np.random.default_rng(seed)
  return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), n


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
@pytest.mark.parametrize('input_layout', ['COO', 'CSR', 'CSC'])
def test_topology_inputs_and_conversions(input_layout, layout):
  ei, n = _coo()
  eids = np.arange(100, 100 + ei.shape[1])
  w = np.random.default_rng(1).random(ei.shape[1]).astype(np.float32)
  if input_layout == 'COO':
    src = ei
  else:
    base = glt.data.Topology(ei, layout=input_layout, num_nodes=n)
    src = (base.indptr, base.indices)
    eids, w = base.edge_ids, base.edge_weights
  j = glt.data.Topology(src, eids, w, input_layout, layout, n)
  t = gtt.data.Topology(src, eids, w, input_layout, layout, n)
  for a in ('indptr', 'indices', 'edge_ids', 'edge_weights'):
    if getattr(j, a) is None:
      assert getattr(t, a) is None
    else:
      np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
  assert t.num_nodes == j.num_nodes and t.num_edges == j.num_edges
  ids = np.array([0, 3, n - 1])
  np.testing.assert_array_equal(t.degree(ids), j.degree(ids))
  for a, b in zip(t.to_coo(), j.to_coo()):
    np.testing.assert_array_equal(a, b)
  for a, b in zip(t.to_csc(), j.to_csc()):
    if b is None:
      assert a is None
    else:
      np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('mode', ['HBM', 'CUDA', 'DMA', 'DEVICE',
                                  'ZERO_COPY', 'CPU', 'cpu'])
def test_graph_modes(mode):
  ei, n = _coo()
  topo = gtt.data.Topology(ei, num_nodes=n)
  g = gtt.data.Graph(topo, mode, CPU)
  assert g.mode == ('CPU' if mode.upper() == 'CPU' else 'HBM')
  assert g.device == torch.device(CPU) and g.layout == 'CSR'
  np.testing.assert_array_equal(g.degree([1, 2]), topo.degree([1, 2]))
  assert g.share_ipc() == (topo, g.mode)
  with pytest.raises(ValueError, match='graph mode'):
    gtt.data.Graph(topo, 'NVME', CPU)


def test_cpu_mode_keeps_the_graph_on_the_host_and_samples_like_jax():
  """``graph_mode='CPU'`` on a dataset whose device is another: the CSR
  stays on the host (``Graph.device`` is the CPU) and a sampler copies it
  to its own device (``Graph.on``); the batches equal JAX's."""
  ei, n = _coo()
  feat = np.arange(n, dtype=np.float32)[:, None].repeat(3, 1)
  jds = glt.data.Dataset()
  jds.init_graph(ei, None, None, 'COO', 'CPU', None, n)
  jds.init_node_features(feat)
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(ei, None, None, 'COO', 'CPU', None, n)
  ds.init_node_features(feat)
  assert ds.graph.mode == 'CPU' and ds.graph.indptr.device.type == 'cpu'
  meta = torch.device('meta')
  moved = ds.graph.on(meta)
  assert moved.mode == 'HBM' and moved.indices.device == meta
  assert moved.topo is ds.graph.topo and ds.graph.on(CPU) is ds.graph
  jb = list(glt.loader.NeighborLoader(jds, [2, 2], np.arange(8),
                                      batch_size=4, dedup='tree'))
  tb = list(gtt.loader.NeighborLoader(ds, [2, 2], np.arange(8), 4,
                                      False, False, False, False, 'random',
                                      True, CPU, dedup='tree'))
  for a, b in zip(jb, tb):
    np.testing.assert_array_equal(b.node.numpy(), np.asarray(a.node))
    np.testing.assert_array_equal(b.x.numpy(), np.asarray(a.x))


def test_dataset_init_graph_in_jax_order():
  ei, n = _coo()
  eids = np.arange(ei.shape[1])[::-1].copy()
  w = np.ones(ei.shape[1], np.float32)
  jds = glt.data.Dataset(edge_dir='in')
  jds.init_graph(ei, eids, w, 'COO', 'HBM', None, n)
  ds = gtt.data.Dataset(edge_dir='in', device=CPU)
  ds.init_graph(ei, eids, w, 'COO', 'HBM', None, n)
  jg, tg = jds.get_graph(), ds.get_graph()
  assert tg.layout == jg.layout == 'CSC'
  np.testing.assert_array_equal(tg.topo.edge_ids, jg.topo.edge_ids)
  np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jg.indices))
  assert ds.get_edge_feature() is None and ds.is_hetero is False


def test_loaders_take_to_device_and_the_alias():
  ei, n = _coo()
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(ei, num_nodes=n)
  ds.init_node_features(np.ones((n, 2), np.float32))
  a = gtt.loader.NeighborLoader(ds, [2], np.arange(4), batch_size=2,
                                to_device=CPU, dedup='tree')
  b = gtt.loader.NeighborLoader(ds, [2], np.arange(4), batch_size=2,
                                device=CPU, dedup='tree')
  assert a.device == b.device == torch.device(CPU)
  with pytest.raises(ValueError, match='disagree'):
    gtt.loader.NeighborLoader(ds, [2], np.arange(4), to_device=CPU,
                              device='meta')
  # collect_features=False gathers no node features, as in JAX
  c = gtt.loader.NeighborLoader(ds, [2], np.arange(4), batch_size=2,
                                collect_features=False, device=CPU)
  assert next(iter(c)).x is None


@pytest.mark.parametrize('dedup', ['tree', 'auto'])
def test_sampler_output_trim_matches_jax(dedup):
  ei, n = _coo(40, 160, 3)
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=n)
  ds = gtt.data.Dataset(device=CPU)
  ds.init_graph(ei, num_nodes=n)
  js = glt.sampler.NeighborSampler(jds.graph, [3, 2], dedup=dedup, seed=4,
                                   with_edge=True)
  ts = gtt.sampler.NeighborSampler(ds.graph, [3, 2], device=CPU,
                                   dedup=dedup, seed=4, with_edge=True)
  seeds = np.array([0, 5, 9, 33])
  a = js.sample_from_nodes(glt.sampler.NodeSamplerInput(seeds)).trim()
  b = ts.sample_from_nodes(gtt.sampler.NodeSamplerInput(seeds)).trim()
  for f in ('node', 'row', 'col', 'edge', 'batch'):
    x, y = getattr(a, f), getattr(b, f)
    assert isinstance(y, np.ndarray), f
    np.testing.assert_array_equal(y, x, err_msg=f)
  assert b.num_nodes == a.num_nodes and b.edge_mask is None
  assert b.num_sampled_nodes == a.num_sampled_nodes
  assert b.num_sampled_edges == a.num_sampled_edges


DIST_TRAINING = [
    ('loader', 'DistFusedEpochTrainer'), ('loader', 'DistScanTrainer'),
    ('recovery', 'FailoverRunner'), ('recovery', 'ShardDeadError'),
    ('recovery', 'remaining_seeds'), ('sampler', 'CapacityPlan'),
    ('sampler', 'CapacityPlanError'), ('sampler', 'ack_edge_ids'),
    ('serving', 'DistEmbeddingStore'), ('serving', 'RotatingShardedStore'),
    ('serving', 'RotationScheduler'),
]


@pytest.mark.parametrize('mod,name', DIST_TRAINING)
def test_distributed_training_signatures(mod, name):
  """The distributed trainers, their failover, ``CapacityPlan`` and the
  sharded serving stores (classes with their public methods)."""
  j, t = getattr(_attr(glt, mod), name), getattr(_attr(gtt, mod), name)
  if inspect.isclass(j):
    _compare_class(name, j, t)
  else:
    assert_same_signature(name, j, t)


REMOTE_CLASSES = [
    ('distributed', 'MpDistNeighborLoader'),
    ('distributed', 'MpDistLinkNeighborLoader'),
    ('distributed', 'RemoteDistNeighborLoader'),
    ('distributed', 'RemoteDistLinkNeighborLoader'),
    ('distributed', 'DistMpSamplingProducer'),
    ('distributed', 'DistCollocatedSamplingProducer'),
    ('distributed', 'CollocatedDistSamplingWorkerOptions'),
    ('distributed', 'MpDistSamplingWorkerOptions'),
    ('distributed', 'RemoteDistSamplingWorkerOptions'),
    ('distributed', 'DistServer'), ('distributed', 'RpcServer'),
    ('distributed', 'RpcClient'), ('distributed', 'RpcCalleeBase'),
    ('distributed', 'RpcDataPartitionRouter'), ('distributed', 'Barrier'),
    ('distributed', 'RetryPolicy'), ('distributed', 'Heartbeat'),
    ('distributed', 'ServerDeadError'), ('distributed', 'ConcurrentEventLoop'),
    ('distributed', 'DistRandomPartitioner'),
    ('distributed', 'DistTableDataset'),
    ('channel', 'ShmChannel'), ('channel', 'MpChannel'),
    ('channel', 'RemoteReceivingChannel'), ('channel', 'PeerDeadError'),
    ('channel', 'QueueTimeoutError'), ('channel', 'ChannelBase'),
    ('sampler', 'SamplingConfig'), ('sampler', 'RemoteNodePathSamplerInput'),
]
REMOTE_FUNCTIONS = [
    ('distributed', 'init_server'), ('distributed', 'get_server'),
    ('distributed', 'wait_and_shutdown_server'),
    ('distributed', 'init_client'), ('distributed', 'request_server'),
    ('distributed', 'async_request_server'),
    ('distributed', 'shutdown_client'), ('distributed', 'get_free_port'),
    ('distributed', 'output_to_message'), ('distributed', 'message_to_data'),
    ('distributed.message', 'hetero_output_to_message'),
    ('distributed.rpc', 'register_wire_error'),
    ('distributed.dist_client', 'barrier'),
    ('distributed.dist_client', 'get_client'),
    ('distributed.resilience', 'env_float'),
    ('distributed.resilience', 'env_int'),
    ('channel', 'serialize_message'), ('channel', 'deserialize_message'),
    ('channel', 'live_channel_count'),
    ('utils', 'fault_point'), ('utils.faults', 'arm'),
    ('utils.faults', 'disarm'), ('utils.faults', 'armed'),
    ('utils.faults', 'stats'), ('utils.faults', 'injected'),
    ('utils.faults', 'env_spec'), ('utils.faults', 'load_env'),
    ('utils', 'counter_inc'), ('utils', 'counter_get'),
    ('utils', 'counters'), ('utils', 'reset_counters'),
    ('utils.build', 'native_lib_path'), ('utils.build', 'build_native'),
    ('utils.build', 'load_native'),
]


def _remote_attr(pkg, dotted):
  import importlib
  mod, _, name = dotted.rpartition(':')
  return getattr(importlib.import_module(f'{pkg.__name__}.{mod}'), name)


@pytest.mark.parametrize('mod,name', REMOTE_CLASSES)
def test_remote_stack_class_signatures(mod, name):
  """The multiprocess and server-client stack's classes (their public
  methods too), the channels and the producers' options."""
  _compare_class(name, _remote_attr(glt, f'{mod}:{name}'),
                 _remote_attr(gtt, f'{mod}:{name}'))


@pytest.mark.parametrize('mod,name', REMOTE_FUNCTIONS)
def test_remote_stack_function_signatures(mod, name):
  assert_same_signature(name, _remote_attr(glt, f'{mod}:{name}'),
                        _remote_attr(gtt, f'{mod}:{name}'))


REMOTE_SCAN_CLASSES = [
    ('distributed', 'RemoteScanTrainer'), ('distributed', 'RemoteBlockStager'),
    ('distributed', 'BlockSampleProducer'), ('distributed', 'TenantSpec'),
    ('distributed', 'TenancyConfig'), ('distributed', 'TenantRejection'),
    ('distributed', 'TenantQuotaExceeded'), ('distributed', 'TenantThrottled'),
    ('distributed', 'TenantStarvedError'),
    ('distributed', 'AdmissionController'),
    ('distributed', 'WeightedFairScheduler'),
]
REMOTE_SCAN_FUNCTIONS = [
    ('distributed', 'stack_block_frames'), ('distributed', 'block_mb_per_chunk'),
    ('distributed', 'with_backpressure'),
    ('distributed.block_producer', '_pad_pow2_axis0'),
]


@pytest.mark.parametrize('mod,name', REMOTE_SCAN_CLASSES)
def test_remote_scan_class_signatures(mod, name):
  """The chunk-staged remote scan and the tenancy plane: their classes
  and public methods (``RemoteScanTrainer`` without ``tx`` or
  ``config=``, with ``device=`` and ``capture=`` last; the stager's
  slot packing; ``TenantSpec`` and ``TenancyConfig`` as JAX's
  dataclasses)."""
  _compare_class(name, _remote_attr(glt, f'{mod}:{name}'),
                 _remote_attr(gtt, f'{mod}:{name}'))


@pytest.mark.parametrize('mod,name', REMOTE_SCAN_FUNCTIONS)
def test_remote_scan_function_signatures(mod, name):
  assert_same_signature(name, _remote_attr(glt, f'{mod}:{name}'),
                        _remote_attr(gtt, f'{mod}:{name}'))


TUNE_NAMES = _public(glt.tune)


@pytest.mark.parametrize('name', TUNE_NAMES)
def test_tune_signatures(name):
  """The tuner's public calls (``tune``, the probes' candidates, the
  artifact's methods, the topology field, the retune scheduler and its
  probes): JAX's, the fused-hop default aside; and the seven
  ``config=`` acceptors take it where JAX does."""
  assert _public(gtt.tune) == TUNE_NAMES
  j, t = getattr(glt.tune, name), getattr(gtt.tune, name)
  if inspect.isclass(j):
    _compare_class(name, j, t)
  elif inspect.isfunction(j):
    assert_same_signature(name, j, t)


@pytest.mark.parametrize('qual', [
    'loader.ScanTrainer', 'loader.RunTrainer', 'loader.DistScanTrainer',
    'storage.TieredScanTrainer', 'storage.TieredDistScanTrainer',
    'distributed.RemoteScanTrainer', 'serving.ServingEngine'])
def test_config_acceptors_take_config_after_jax_parameters(qual):
  """``config`` sits after the same JAX parameter in both packages (the
  port's extra parameters, ``capture`` / ``device``, come after it)."""
  mod, name = qual.split('.')
  jp = list(inspect.signature(
      getattr(getattr(glt, mod), name).__init__).parameters)
  tp = list(inspect.signature(
      getattr(getattr(gtt, mod), name).__init__).parameters)
  before = jp[jp.index('config') - 1]
  assert tp[tp.index('config') - 1] == before, qual
  assert inspect.signature(getattr(getattr(gtt, mod), name).__init__
                           ).parameters['config'].default is None
