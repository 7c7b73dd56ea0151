"""The port's observability layer against JAX's: the closed name lists,
the flight recorder, the program observatory, dispatch counting,
logcheck and the profiler reader.

Same inputs through both packages: the registries' names (JAX's plus the
port's four producer metrics), every name the port's source emits, the
record schemas (each port record passes JAX's logcheck and the port's),
a ``ScanTrainer`` epoch's flight record at the same tiny size (the same
keys and dispatch counts), the observatory's counts and signature diffs
for the same call sequence, the collocated loader's published feature
counters against JAX's, and ``device_op_ms`` over a ``torch.profiler``
trace of CPU ops.
"""
import ast
import json
import os
import pathlib
import warnings

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.metrics import flight as jflight
from graphlearn_tpu.metrics import logcheck as jlogcheck
from graphlearn_tpu.metrics import programs as jprograms
from graphlearn_tpu.metrics import registry_names as jnames
from graphlearn_tpu.utils import trace as jtrace
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.metrics import (flight, logcheck, programs,
                                          registry_names, spans)
from graphlearn_tpu_torch.models import train as ttrain
from graphlearn_tpu_torch.utils import trace
from test_torch_cuda import published

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

PKG = pathlib.Path(gtt.__file__).resolve().parent
PORT_ONLY = {'producer.sample_gather_ms', 'producer.d2h_ms',
             'producer.send_ms', 'producer.message_bytes'}
METRIC_CALLS = {'inc', 'observe', 'set_gauge', 'counter_inc'}
SPAN_CALLS = {'span', 'begin', 'emit'}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  for var in ('GLT_RUN_LOG', 'GLT_SPAN_LOG', 'GLT_STRICT',
              'GLT_PROFILE_DIR'):
    monkeypatch.delenv(var, raising=False)
  yield


# ---------------------------------------------------------------- names


def test_registry_names_are_jax_s_plus_the_port_s_four():
  assert registry_names.REGISTERED_SPANS == jnames.REGISTERED_SPANS
  assert len(jnames.REGISTERED_METRICS) == 80
  assert len(jnames.REGISTERED_SPANS) == 24
  assert registry_names.REGISTERED_METRICS - jnames.REGISTERED_METRICS \
      == PORT_ONLY
  assert jnames.REGISTERED_METRICS <= registry_names.REGISTERED_METRICS
  assert metrics.REGISTERED_METRICS is registry_names.REGISTERED_METRICS


def _registered(name: str, names) -> bool:
  return name in names or any(
      n.endswith('.*') and name.startswith(n[:-1]) for n in names)


def _emitted_names():
  """``(file, line, kind, name or head, literal)`` of every metric / span
  call in the port's source whose receiver is the metrics or spans
  module (``metrics.inc``, ``trace.counter_inc``, ``spans.span``, ...)."""
  out = []
  for path in sorted(PKG.rglob('*.py')):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
      if not (isinstance(node, ast.Call) and node.args and
              isinstance(node.func, ast.Attribute) and
              isinstance(node.func.value, ast.Name)):
        continue
      recv, attr = node.func.value.id, node.func.attr
      if recv in ('metrics', 'trace') and attr in METRIC_CALLS:
        kind = 'metric'
      elif recv == 'spans' and attr in SPAN_CALLS:
        kind = 'span'
      else:
        continue
      arg = node.args[0]
      rel = str(path.relative_to(PKG))
      # a conditional name: both of its literals
      args = ([arg.body, arg.orelse] if isinstance(arg, ast.IfExp)
              else [arg])
      if all(isinstance(a, ast.Constant) and isinstance(a.value, str)
             for a in args):
        out += [(rel, node.lineno, kind, a.value, True) for a in args]
      elif isinstance(arg, ast.JoinedStr):
        head = ''.join(v.value for v in arg.values[:1]
                       if isinstance(v, ast.Constant))
        out.append((rel, node.lineno, kind, head, False))
      else:
        out.append((rel, node.lineno, kind, None, False))
  return out


def test_every_name_the_port_emits_is_registered():
  """Literal names are registered; an f-string's literal head falls in a
  ``<prefix>.*`` family. The one computed head is ``publish_stats``'s
  caller-chosen prefix, whose two families are registered (checked
  by running it below)."""
  found = _emitted_names()
  for rel, line, kind, name, literal in found:
    names = (registry_names.REGISTERED_METRICS if kind == 'metric'
             else registry_names.REGISTERED_SPANS)
    where = f'{rel}:{line}'
    if literal:
      assert _registered(name, names), (where, name)
    elif name:
      assert any(n.endswith('.*') and name.startswith(n[:-1])
                 for n in names), (where, name)
    else:
      assert rel == os.path.join('distributed', 'dist_feature.py'), where
  emitted = {n for _, _, k, n, lit in found if lit and k == 'span'}
  # every span JAX's runtime modules open has its site in the port, the
  # tuner's included
  assert emitted == set(registry_names.REGISTERED_SPANS)


# ---------------------------------------------------------------- flight


N, F, C = 96, 6, 3


def _graph():
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(N), 4)
  cols = (rows + rng.integers(1, N, rows.shape[0])) % N
  return (np.stack([rows, cols]), rng.standard_normal((N, F)).astype(
      np.float32), rng.integers(0, C, N))


def _pool():
  return np.random.default_rng(9).permutation(N)[:44].astype(np.int64)


def _port_trainer():
  ei, feats, labels = _graph()
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=N)
  ds.init_node_features(feats)
  ds.init_node_labels(labels)
  loader = gtt.loader.NeighborLoader(ds, [3, 2], _pool(), batch_size=8,
                                     shuffle=False, seed=0, device='cpu')
  model = gtt.models.GraphSAGE(F, 8, C, num_layers=2, device='cpu',
                               generator=torch.Generator().manual_seed(0))
  return (gtt.loader.ScanTrainer(loader, model, C, chunk_size=4),
          ttrain.create_train_state(model))


def _jax_trainer():
  import jax
  from graphlearn_tpu.models import GraphSAGE as JaxSAGE
  from graphlearn_tpu.models import train as jtrain
  ei, feats, labels = _graph()

  def loader():
    ds = glt.data.Dataset()
    ds.init_graph(ei, graph_mode='CPU', num_nodes=N)
    ds.init_node_features(feats)
    ds.init_node_labels(labels)
    return glt.loader.NeighborLoader(ds, [3, 2], _pool(), batch_size=8,
                                     shuffle=False, seed=0)

  model = JaxSAGE(hidden_dim=8, out_dim=C, num_layers=2)
  first = jtrain.batch_to_dict(next(iter(loader())))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0), first)
  return glt.loader.ScanTrainer(loader(), model, tx, C, chunk_size=4), state


def test_scan_trainer_flight_record_matches_jax_s(tmp_path, monkeypatch):
  """The same tiny epoch (44 seeds at batch 8, K = 4: 6 steps, 2 chunks)
  through both trainers under GLT_RUN_LOG and count_dispatches: the
  records have the same keys and the same per-site dispatch counts,
  pass both logchecks, and the port's ``programs`` field counts its
  chunks (a CPU epoch runs them eagerly: no capture)."""
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'jax.jsonl'))
  jtrainer, jstate = _jax_trainer()
  with jtrace.count_dispatches():
    jtrainer.run_epoch(jstate)
  (jrec,) = [r for r in jflight.read_records()
             if r['emitter'] == 'ScanTrainer']
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'port.jsonl'))
  trainer, state = _port_trainer()
  with trace.count_dispatches() as dc:
    trainer.run_epoch(state)
    trainer.run_epoch(state)
  recs = flight.read_records()
  assert len(recs) == 2
  for rec in recs:
    assert set(rec) == set(jrec)
    assert rec['dispatch'] == jrec['dispatch'] == {
        'epoch_seeds': 1, 'scan_chunk': 2, 'metrics_concat': 1}
    assert rec['dispatch_total'] == jrec['dispatch_total'] == 4
    assert rec['programs'] == {'scan_chunk': {'dispatches': 2}}
    assert (rec['emitter'], rec['steps'], rec['completed']) == \
        (jrec['emitter'], jrec['steps'], True)
    assert rec['config'] == jrec['config']
    assert rec['config_fingerprint'] == jrec['config_fingerprint']
    assert rec['run_id'] == spans.run_id()
    assert jlogcheck.validate_flight_record(rec) == []
    assert logcheck.validate_flight_record(rec) == []
  assert [r['epoch'] for r in recs] == [0, 1]
  assert dc.total == 8
  assert logcheck.check_file(str(tmp_path / 'port.jsonl')) == []
  assert jlogcheck.check_file(str(tmp_path / 'port.jsonl')) == []


def test_failed_epoch_records_completed_false(tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'run.jsonl'))
  trainer, state = _port_trainer()

  def boom(c, start, k):
    if c == 1:
      raise RuntimeError('boom')

  trainer.stage_hook = boom
  with pytest.raises(RuntimeError, match='boom'):
    trainer.run_epoch(state)
  (rec,) = flight.read_records()
  assert rec['completed'] is False and rec['steps'] == 4
  assert rec['epoch'] == 0 and rec['start_step'] == 0
  assert spans.current() == (None, None)   # no span leaked on the thread


def test_recording_off_writes_nothing(tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  assert flight.epoch_begin() is None
  assert flight.epoch_end(None, emitter='x', epoch=0, steps=1) is None
  trainer, state = _port_trainer()
  trainer.run_epoch(state)
  for batch in trainer.loader:
    pass
  assert os.listdir(tmp_path) == []


def _store_counters(tr) -> dict:
  return {k: v for k, v in tr.counters().items()
          if k.startswith(('dist_feature.', 'dist_label.'))}


def test_dist_loader_feature_fields_bit_match_the_live_counters(
    tmp_path, monkeypatch):
  """A collocated DistNeighborLoader epoch publishes its stores' counters
  once (one read each) before its flight record: the record's
  ``feature`` fields equal the published counter deltas (the feature
  store's and the sampler's label store's), which equal JAX's for the
  same epoch."""
  from test_torch_distributed import _loader_pair, ring
  labels = np.arange(40) % 3
  jl, tl = _loader_pair(2, ring(2), labels, batch_size=4, seed=0)
  before, jbefore = _store_counters(trace), _store_counters(jtrace)
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'run.jsonl'))
  n = sum(1 for _ in tl)
  monkeypatch.setenv('GLT_RUN_LOG', str(tmp_path / 'jax.jsonl'))
  for _ in jl:
    pass
  (rec,) = flight.read_records(str(tmp_path / 'run.jsonl'))
  (jrec,) = jflight.read_records(str(tmp_path / 'jax.jsonl'))
  live = {k: v - before.get(k, 0) for k, v in _store_counters(trace).items()
          if v != before.get(k, 0)}
  jlive = {k: v - jbefore.get(k, 0)
           for k, v in _store_counters(jtrace).items()
           if v != jbefore.get(k, 0)}
  assert rec['steps'] == n and rec['emitter'] == 'DistNeighborLoader'
  assert rec['feature'] == live == jlive == jrec['feature']
  assert live['dist_feature.lookups'] > 0
  assert tl.data.node_features.stats()['lookups'] == 0   # drained


def test_publish_stats_prefixes_land_in_registered_families():
  store = gtt.distributed.DistFeature(
      1, [(np.arange(4), np.ones((4, 2), np.float32))],
      np.zeros(4, np.int32), mesh=gtt.distributed.ShardMesh(1, 'cpu'))
  for prefix in ('dist_feature', 'dist_label'):
    store.get(torch.zeros((1, 2), dtype=torch.int32))
    got = store.publish_stats(prefix=prefix)
    assert got['lookups'] == 2
    names = trace.counters(prefix)
    assert names and all(_registered(k, registry_names.REGISTERED_METRICS)
                         for k in names)
  assert store.stats()['lookups'] == 0


# ------------------------------------------------------------ observatory


class _Cached:
  """A callable with a program cache keyed by its argument's shape and
  dtype: what ``instrument`` watches in either package."""

  def __init__(self):
    self.cache = set()

  def __call__(self, x):
    self.cache.add((x.shape, str(x.dtype)))
    return x

  def _cache_size(self):
    return len(self.cache)


def _drive(pkg, arrays):
  reg = pkg.ProgramRegistry()
  fn = pkg.instrument(_Cached(), 'site', registry=reg)
  for a in arrays:
    fn(a)
  plain = pkg.instrument(lambda x: x, 'plain', registry=reg)
  plain(arrays[0])
  return reg


def test_program_registry_counts_and_diffs_match_jax_s():
  arrays = [np.ones((4,), np.float32), np.ones((4,), np.float32),
            np.ones((4,), np.int32), np.ones((8,), np.int32),
            np.ones((8,), np.int32)]
  j, t = _drive(jprograms, arrays), _drive(programs, arrays)
  for reg in (j, t):
    assert reg.compile_count('site') == 3 and reg.retrace_count('site') == 2
    assert reg.dispatch_count('site') == 5
    assert reg.compile_count('plain') == 0 and reg.dispatch_count('plain') == 1
  assert [e.diff for e in t.events('site')] == \
      [e.diff for e in j.events('site')] == [
          'first compile', 'arg 0: float32[4] -> int32[4]',
          'arg 0: int32[4] -> int32[8]']
  assert {k: {kk: v for kk, v in s.items() if kk != 'compile_s'}
          for k, s in t.flight_snapshot().items()} == \
      {k: {kk: v for kk, v in s.items() if kk != 'compile_s'}
       for k, s in j.flight_snapshot().items()}
  ja, ta = j.aggregate(), t.aggregate()
  assert set(ta) == set(ja)
  assert (ta['compile_count'], ta['retrace_count']) == \
      (ja['compile_count'], ja['retrace_count']) == (3, 2)
  assert ta['program_flops_total'] is None
  # a torch tensor reads as the numpy / JAX array of its shape and dtype
  assert programs.signature_of((torch.ones(8, 4), 7), {}) == \
      jprograms.signature_of((np.ones((8, 4), np.float32), 7), {})


def test_retrace_budget_warns_and_raises_like_jax_s(monkeypatch):
  for pkg in (jprograms, programs):
    reg = pkg.ProgramRegistry()
    fn = pkg.instrument(_Cached(), 'budget', registry=reg)
    fn(np.ones(2))
    with warnings.catch_warnings(record=True) as w:
      warnings.simplefilter('always')
      with pkg.retrace_budget('budget', 0, registry=reg):
        fn(np.ones(3))
    assert len(w) == 1 and 'retrace budget exceeded' in str(w[0].message)
    assert 'float64[2] -> float64[3]' in str(w[0].message)
    monkeypatch.setenv('GLT_STRICT', '1')
    with pytest.raises(pkg.RetraceBudgetExceeded, match='budget'):
      with pkg.retrace_budget('budget', 0, registry=reg):
        fn(np.ones(4))
    with pkg.retrace_budget('budget', 1, registry=reg):
      fn(np.ones(5))
    monkeypatch.delenv('GLT_STRICT')


def test_capture_signature_diff_names_the_changed_state():
  """A recapture (the port's retrace) diffs by name: a new learning rate
  and a longer chunk each show as the one leaf that changed."""
  from graphlearn_tpu_torch.loader.scan_epoch import capture_signature
  model = torch.nn.Linear(2, 2)
  opt = torch.optim.Adam(model.parameters(), lr=0.01)
  bufs = {'seeds': torch.zeros((4, 8), dtype=torch.int32)}
  a = capture_signature(4, bufs, model, opt)
  opt.param_groups[0]['lr'] = 0.001
  b = capture_signature(4, bufs, model, opt)
  diff = programs.diff_signatures(a, b)
  assert diff.count('arg ') == 1
  assert 'static:group0.lr=0.01 -> static:group0.lr=0.001' in diff
  c = capture_signature(2, {'seeds': bufs['seeds'][:2]}, model, opt)
  assert 'static:k=4 -> static:k=2' in programs.diff_signatures(b, c)
  assert 'int32[4,8] -> seeds:int32[2,8]' in programs.diff_signatures(b, c)


def test_dispatch_counter_propagates_like_jax_s():
  for tr in (jtrace, trace):
    with tr.count_dispatches() as outer:
      tr.record_dispatch('a')
      with tr.count_dispatches(propagate=True) as inner:
        tr.record_dispatch('b')
        tr.wrap_dispatch(lambda: None, 'c')()
      with tr.count_dispatches():
        tr.record_dispatch('lost')
      assert tr.dispatch_snapshot() == {'a': 1, 'b': 1, 'c': 1}
    assert inner.total == 2 and outer.subtotal('b') == 1
    assert outer.counts == {'a': 1, 'b': 1, 'c': 1}
    assert tr.dispatch_snapshot() is None


# --------------------------------------------------------------- logcheck


def test_logcheck_cli_and_drift_like_jax_s(tmp_path):
  bad = tmp_path / 'bad.jsonl'
  bad.write_text(json.dumps({'kind': 'span', 'schema': 1}) + '\n' +
                 json.dumps({'kind': 'mystery'}) + '\n')
  assert logcheck.check_file(str(bad)) == jlogcheck.check_file(str(bad))
  assert logcheck.main([str(bad), '-q']) == 1
  assert logcheck.main(['-q']) == 0          # the recorders' self-check


# --------------------------------------------------------------- profiler


def test_device_op_ms_reads_a_cpu_profile(tmp_path):
  """``profile_trace`` over CPU ops exports a Chrome trace whose device
  is the CPU: ``device_op_ms`` counts each op's calls, and an annotated
  range is a program of ``device_program_ms``."""
  x = torch.ones(64, 64)
  with trace.profile_trace(str(tmp_path)):
    for i in range(3):
      with trace.step_annotation('glt_step', i):
        torch.mm(x, x)
  assert list(tmp_path.glob('*.pt.trace.json'))
  ops_ms = trace.device_op_ms(str(tmp_path))
  assert ops_ms['aten::mm'][1] == 3 and ops_ms['aten::mm'][0] >= 0
  top = trace.device_op_ms(str(tmp_path), top=1, steps=3)
  assert len(top) == 1
  progs = trace.device_program_ms(str(tmp_path))
  assert {n: c for n, (_, c) in progs.items()} == {
      'glt_step#step_num=0#': 1, 'glt_step#step_num=1#': 1,
      'glt_step#step_num=2#': 1}


def test_maybe_start_trace_stamps_spans_and_exports(tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_PROFILE_DIR', str(tmp_path))
  assert trace.maybe_start_trace() == str(tmp_path)
  assert trace.maybe_start_trace() is None          # one session at a time
  assert trace.active_profile_dir() == str(tmp_path)
  rec = spans.end(spans.begin('epoch.run', emitter='test'))
  assert rec['profile_key'] == str(tmp_path)
  torch.ones(4).sum()
  trace.stop_trace()
  assert trace.active_profile_dir() is None
  assert 'aten::sum' in trace.device_op_ms(str(tmp_path))
  assert 'profile_key' not in spans.end(spans.begin('epoch.run'))
