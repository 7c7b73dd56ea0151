"""The port's spans against JAX's: the span module on the same call
sequence, a trace across the two packages' RPC (frames byte-compatible
both ways), ``scrape_all`` over a port ``DistServer``, and the serving
engine's request tree.

The span rings are process-global per package: each test resets both
and reads its own trace ids.
"""
import time

import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.metrics import logcheck as jlogcheck
from graphlearn_tpu.metrics import spans as jspans
from graphlearn_tpu_torch import metrics
from graphlearn_tpu_torch.metrics import logcheck, spans

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

gdist = gtt.distributed


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.delenv('GLT_SPAN_LOG', raising=False)
  spans.reset()
  jspans.reset()
  yield


def _shape(rows):
  """A span list without its ids and clocks: (name, parent's name,
  attrs) in order."""
  by_id = {r['span']: r for r in rows}
  return [(r['name'], by_id[r['parent']]['name'] if r['parent'] in by_id
           else r['parent'], r.get('attrs')) for r in rows]


def _sequence(mod):
  with mod.new_trace('t-seq') as tid:
    with mod.span('epoch.run', emitter='test', epoch=0):
      with mod.span('epoch.chunk', start=0, k=4):
        pass
      tok = mod.begin('serving.request', attach=False, n=3)
      mod.emit('serving.queue', trace=tok.trace, parent=tok.span_id,
               dur_ms=0.5)
      mod.end(tok, batch='b')
    with mod.adopt({'trace': 'remote', 'span': 'rs'}):
      assert mod.wire_context() == {'trace': 'remote', 'span': 'rs'}
      with mod.span('rpc.server.handle', func='f') as h:
        assert (h.trace, h.parent) == ('remote', 'rs')
    assert mod.current() == (tid, None)
  assert mod.current() == (None, None)
  return mod.export(trace='t-seq'), mod.export(trace='remote')


def test_span_lifecycle_matches_jax_s():
  jrows, jremote = _sequence(jspans)
  trows, tremote = _sequence(spans)
  assert _shape(trows) == _shape(jrows)
  assert _shape(tremote) == _shape(jremote)
  for r in trows + tremote:
    assert set(r) <= set(jrows[0]) | {'attrs'}
    assert jlogcheck.validate_span(r) == [] == logcheck.validate_span(r)
    assert r['run'] == spans.run_id() and r['dur_ms'] >= 0
  tree = spans.build_tree(trows + trows)       # duplicates collapse
  jtree = jspans.build_tree(jrows)
  assert len(tree['spans']) == len(jtree['spans']) == 4
  assert len(tree['roots']) == len(jtree['roots']) == 1
  assert not tree['orphans'] and not jtree['orphans']
  orphan = dict(trows[0], span='zz-1', parent='never-recorded')
  assert spans.build_tree(trows + [orphan])['orphans'] == ['zz-1']


def test_span_log_is_jsonl_both_logchecks_accept(tmp_path, monkeypatch):
  path = tmp_path / 'spans.jsonl'
  monkeypatch.setenv('GLT_SPAN_LOG', str(path))
  with spans.new_trace('req') as tid:
    with spans.span('epoch.run', emitter='test'):
      spans.emit('serving.queue', dur_ms=1.25)
  rows = spans.read_log(str(path))
  assert {r['name'] for r in rows} == {'epoch.run', 'serving.queue'}
  assert all(r['trace'] == tid for r in rows)
  assert logcheck.check_file(str(path)) == []
  assert jlogcheck.check_file(str(path)) == []
  assert jspans.read_log(str(path)) == rows
  with open(path, 'a') as fh:
    fh.write('not json\n')
  assert len(spans.read_log(str(path))) == 2


@pytest.mark.parametrize('server_pkg,client_pkg', [('jax', 'port'),
                                                   ('port', 'jax')])
def test_a_request_across_the_packages_joins_one_trace(server_pkg,
                                                       client_pkg):
  """A client of one package calls a server of the other: the client's
  ``rpc.client.request`` span and the server's ``rpc.server.handle``
  span (and one the handler opens) share the request's trace id, the
  server's parented under the client's, and the two rings assemble into
  one tree."""
  dist = {'jax': glt.distributed, 'port': gdist}
  smod = jspans if server_pkg == 'jax' else spans
  cmod = jspans if client_pkg == 'jax' else spans

  def handler(x):
    with smod.span('serving.request', n=int(np.size(x))):
      return np.asarray(x) * 2

  server = dist[server_pkg].RpcServer(handlers={'twice': handler})
  client = dist[client_pkg].RpcClient()
  client.add_target(0, server.host, server.port)
  try:
    with cmod.new_trace() as req:
      out = client.request_sync(0, 'twice', np.arange(3))
    np.testing.assert_array_equal(out, np.arange(3) * 2)
  finally:
    client.close()
    server.shutdown()
  rows = spans.dedupe(spans.export(trace=req) + jspans.export(trace=req))
  tree = spans.build_tree(rows)
  assert {r['name'] for r in rows} == {'rpc.client.request',
                                       'rpc.server.handle',
                                       'serving.request'}
  assert not tree['orphans'] and len(tree['roots']) == 1
  root = tree['spans'][tree['roots'][0]]
  assert root['name'] == 'rpc.client.request'
  assert root['attrs'] == {'rank': 0, 'func': 'twice', 'ok': True}
  (handle,) = tree['children'][root['span']]
  assert tree['spans'][handle]['name'] == 'rpc.server.handle'
  assert tree['spans'][handle]['attrs'] == {'func': 'twice'}


def _dataset():
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(40), 3)
  cols = (rows + rng.integers(1, 40, rows.shape[0])) % 40
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(np.stack([rows, cols]), num_nodes=40)
  ds.init_node_features(rng.standard_normal((40, 4)).astype(np.float32))
  ds.init_node_labels(np.arange(40) % 3)
  return ds


def test_scrape_all_over_a_port_server_and_a_dead_one():
  """``scrape_all`` with a connected port ``DistServer``: the
  ``server/0`` entry carries the server's run id and span ring (the
  scrape's own ``rpc.server.handle``), merges with the local snapshot,
  and a server that does not answer is an ``{'error': ...}`` entry."""
  host, port = gdist.init_server(1, 1, 0, _dataset())
  gdist.init_client(1, 1, 0, [(host, port)])
  client = gdist.dist_client.get_client()
  try:
    with spans.span('epoch.run', emitter='scrape-test'):
      pass
    metrics.scrape_all(timeout=5.0)
    # the second scrape's ring holds the first one's handler span
    scr = metrics.scrape_all(timeout=5.0)
    assert set(scr) >= {'server/0'}
    srv = scr['server/0']
    assert srv['run_id'] == spans.run_id()
    assert 'rpc.server.handle' in {r['name'] for r in srv['spans']}
    local = [v for k, v in scr.items() if k != 'server/0']
    assert local and 'epoch.run' in {r['name'] for r in local[0]['spans']}
    assert 'counters' in metrics.merge_scrape(scr)
    metrics.register_source('producer/9', lambda: 1 / 0)
    try:
      client.add_target(1, '127.0.0.1', gdist.get_free_port())
      before = metrics.counter('metrics.scrape_error').value
      scr = metrics.scrape_all(timeout=2.0)
    finally:
      metrics.unregister_source('producer/9')
    assert 'ZeroDivisionError' in scr['producer/9']['error']
    assert 'error' in scr['server/1'] and 'error' not in scr['server/0']
    assert metrics.counter('metrics.scrape_error').value - before == 2
    assert 'counters' in metrics.merge_scrape(scr)
  finally:
    client._addrs.pop(1, None)
    gdist.shutdown_client()
    gdist.wait_and_shutdown_server(timeout=30)


def test_serving_request_tree_and_latency_agree():
  """Each ``lookup`` yields one ``serving.request`` span with its queue,
  batch (-> compute) and respond children; the request spans' p50 is
  within one log bucket of the ``serving.total_ms`` histogram's, as in
  JAX."""
  emb = np.arange(120, dtype=np.float32).reshape(30, 4)
  store = gtt.serving.EmbeddingStore(emb, num_nodes=30, device='cpu')
  metrics.reset('serving')
  with gtt.serving.ServingEngine(store, buckets=(8,),
                                 max_wait_ms=0.5) as eng:
    with spans.new_trace() as req:
      np.testing.assert_array_equal(eng.lookup(np.array([3, 4])),
                                    emb[[3, 4]])
    for i in range(20):
      eng.lookup(np.arange(1 + (i % 7)))
  deadline = time.monotonic() + 5
  while time.monotonic() < deadline and len(
      [r for r in spans.export() if r['name'] == 'serving.request']) < 21:
    time.sleep(0.01)
  mine = spans.export(trace=req)
  tree = spans.build_tree(mine)
  assert not tree['orphans'] and len(tree['roots']) == 1
  root = tree['spans'][tree['roots'][0]]
  assert root['name'] == 'serving.request'
  kids = {tree['spans'][c]['name'] for c in tree['children'][root['span']]}
  assert kids == {'serving.queue', 'serving.batch', 'serving.respond'}
  durs = np.array([r['dur_ms'] for r in spans.export()
                   if r['name'] == 'serving.request'])
  hist = metrics.histogram('serving.total_ms')
  assert hist.count == durs.shape[0] == 21
  p50 = float(np.percentile(durs, 50))
  h50 = float(hist.percentiles()['p50'])
  assert max(p50, h50) / max(min(p50, h50), 1e-9) <= 10 ** 0.25 * 1.05
