"""The port's homogeneous GCN / GAT family against flax.

``GCNConv``, ``GCN``, ``GATConv`` and the ``GAT`` stack in its segment,
layered, tree-dense (``TreeGATConv``) and merge-dense (``MergeGATConv``)
forwards, outputs and gradients, with the flax parameters carried by
``models.convert``; the dense forwards also against the port's own
segment forward, the run layouts ('window' against 'reshape'), bf16, the
parameters and Adam state through flax / optax, one train step against
optax, the serving materializer with a GAT (and GCN refused), and a
tree-dense GAT in the ScanTrainer. Batches come from the JAX package's
loader; float outputs agree within atol 1e-5, rtol 1e-4, bf16 within
3e-2 of the output's scale. Mirrors tests/test_models.py:34, :204, :511,
:578, :876-1000.
"""
import copy
import inspect

import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import models as M
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
F = 12


def close(a, b, what='', atol=ATOL, rtol=RTOL):
  np.testing.assert_allclose(np.asarray(a, np.float32),
                             np.asarray(b, np.float32), atol=atol,
                             rtol=rtol, err_msg=what)


def jax_batch(dedup, caps=None, seeds=None, n=200, seed=1, isolated=None):
  """One batch dict (numpy) of the JAX loader over a random graph:
  fanouts [4, 3], batch 16; node ``n - 1`` has no out-edges (a leading
  seed without children), or ``isolated`` when given."""
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, 2000)
  cols = rng.integers(0, n, 2000)
  zero = n - 1 if isolated is None else isolated
  keep = rows != zero
  ds = glt.data.Dataset()
  ds.init_graph(np.stack([rows[keep], cols[keep]]), num_nodes=n,
                graph_mode='CPU')
  ds.init_node_features(rng.standard_normal((n, F)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, 4, n))
  seeds = np.array([zero] + list(range(1, 16))) if seeds is None else seeds
  loader = glt.loader.NeighborLoader(ds, [4, 3], seeds, batch_size=16,
                                     seed=0, dedup=dedup,
                                     frontier_caps=caps,
                                     overflow_policy='off')
  b = jtrain.batch_to_dict(next(iter(loader)))
  return {k: np.asarray(v) for k, v in b.items()}


def tdict(b):
  return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def grads_match(tmodel, jgrads, what):
  jg = convert.params_from_flax(jgrads, tmodel)
  for name, p in tmodel.named_parameters():
    assert name in jg, name
    close(p.grad.numpy(), jg[name].numpy(), f'{what} grad {name}',
          atol=1e-5, rtol=2e-4)


def pair(jcls, tcls, b, *targs, jkw=None, **kw):
  """(flax model, its params, the port's model carrying them)."""
  jm = jcls(**(jkw or {}), **kw)
  params = jax.tree.map(np.asarray, jm.init(
      jax.random.PRNGKey(0), b['x'], b['edge_index'], b['edge_mask']))
  dev = dict(device='cpu') if 'device' in inspect.signature(
      tcls).parameters else {}
  tm = tcls(*targs, **dev, **kw)
  sd = convert.params_from_flax(params, tm)
  assert set(sd) == set(dict(tm.named_parameters()))
  tm.load_state_dict(sd)
  return jm, params, tm


def check_forward_and_grads(jm, params, tm, b, what, rows=None):
  """Output and gradients of ``sum(out * w)`` (``w`` zero past ``rows``)
  equal flax's; returns the port's output."""
  jout = np.asarray(jm.apply(params, b['x'], b['edge_index'],
                             b['edge_mask']))
  w = np.random.default_rng(3).standard_normal(jout.shape).astype(
      np.float32)
  if rows is not None:
    w[rows:] = 0

  def jloss(p):
    return (jm.apply(p, b['x'], b['edge_index'], b['edge_mask']) * w).sum()

  jgrad = jax.tree.map(np.asarray, jax.grad(jloss)(params))
  t = tdict(b)
  tout = tm(t['x'], t['edge_index'], t['edge_mask'])
  assert tout.shape == jout.shape, (what, tout.shape, jout.shape)
  close(tout.detach().numpy(), jout, what)
  (tout * torch.as_tensor(w)).sum().backward()
  grads_match(tm, jgrad, what)
  return tout.detach()


# ------------------------------------------------------------------ GCN


def test_gcn_conv_matches_flax():
  """GCNConv (tests/test_models.py:34): the symmetric degree norm with
  implicit self loops, padded and masked edges, a node without edges;
  output and gradients."""
  from graphlearn_tpu.models.conv import GCNConv as JGCN
  rng = np.random.default_rng(0)
  n, e = 20, 64
  x = rng.standard_normal((n, 6)).astype(np.float32)
  ei = np.stack([rng.integers(0, n - 1, e), rng.integers(0, n - 3, e)])
  ei[:, 50:] = -1
  em = ei[1] >= 0
  em[40:45] = False
  b = dict(x=x, edge_index=ei.astype(np.int32), edge_mask=em)
  jm, params, tm = pair(JGCN, gtt.models.GCNConv, b, 6, out_dim=5)
  assert 'Dense_0' in params['params']
  check_forward_and_grads(jm, params, tm, b, 'gcn conv')


def test_gcn_and_its_layer_slices_match_flax():
  """GCN (2 layers): the forward, its gradients and its layer slices,
  which compose to the full forward."""
  b = jax_batch('tree')
  jm, params, tm = pair(glt.models.GCN, gtt.models.GCN, b, F, hidden_dim=8,
                        out_dim=4)
  full = check_forward_and_grads(jm, params, tm, b, 'gcn')
  t = tdict(b)
  with torch.no_grad():
    h = tm(t['x'], t['edge_index'], t['edge_mask'], layers=(0, 1))
    out = tm(torch.relu(h), t['edge_index'], t['edge_mask'], layers=(1, 2))
  close(out.numpy(), full.numpy(), 'gcn slices')
  jh = np.asarray(jm.apply(params, b['x'], b['edge_index'], b['edge_mask'],
                           layers=(0, 1)))
  close(h.numpy(), jh, 'gcn slice 0')


# ------------------------------------------------------------------ GAT

FORWARDS = {
    'segment': ('tree', None, {}),
    'layered_tree': ('tree', None, dict(layered=True)),
    'tree_dense': ('tree', None, dict(tree_dense=True)),
    'layered_merge': ('map', None, dict(layered=True)),
    'merge_dense': ('map', None, dict(merge_dense=True)),
    'merge_dense_caps': ('map', [40, 88], dict(merge_dense=True)),
}


def gat_kw(dedup, caps, flags):
  kw = dict(hidden_dim=8, out_dim=4, num_layers=2, heads=2)
  if flags:
    offs = (jtrain.tree_hop_offsets(16, [4, 3]) if dedup == 'tree' else
            jtrain.merge_hop_offsets(16, [4, 3], frontier_caps=caps))
    kw.update(hop_node_offsets=offs[0], hop_edge_offsets=offs[1])
    for f in ('tree_dense', 'merge_dense'):
      if flags.get(f):
        kw.update({f: True, 'fanouts': (4, 3)})
  return kw


@pytest.mark.parametrize('forward', list(FORWARDS))
def test_gat_forwards_match_flax_and_segment(forward):
  """GAT's four forwards (tests/test_models.py:204, :511): outputs and
  gradients equal flax's with the same parameters, and the seed logits
  of the layered and dense forwards equal the port's own segment
  forward's, on tree and merge batches (calibrated caps included); a
  leading seed has no children."""
  dedup, caps, flags = FORWARDS[forward]
  b = jax_batch(dedup, caps)
  nseed = int(b['num_seed_nodes'])
  jm, params, tm = pair(glt.models.GAT, gtt.models.GAT, b, F,
                        **gat_kw(dedup, caps, flags))
  out = check_forward_and_grads(jm, params, tm, b, forward, rows=nseed)
  seg = gtt.models.GAT(F, 8, 4, num_layers=2, heads=2, device='cpu')
  seg.load_state_dict(tm.state_dict())
  t = tdict(b)
  with torch.no_grad():
    ref = seg(t['x'], t['edge_index'], t['edge_mask'])
  close(out[:nseed].numpy(), ref[:nseed].numpy(), f'{forward} vs segment')


def test_merge_dense_gat_zero_degree_leading_seed():
  """A hop block led by an all-masked run (seed 0 has no out-edges): the
  block base ``min(tgt - j)`` keeps the write aligned
  (tests/test_models.py:578), against flax and the segment forward."""
  b = jax_batch('map', seeds=np.array([0, 5, 9, 13, 21, 34, 55, 89]),
                isolated=0)
  no, eo = jtrain.merge_hop_offsets(16, [4, 3])
  nseed = int(b['num_seed_nodes'])
  kw = dict(hidden_dim=8, out_dim=3, num_layers=2, heads=2,
            hop_node_offsets=no, hop_edge_offsets=eo)
  jm, params, tm = pair(glt.models.GAT, gtt.models.GAT, b, F,
                        merge_dense=True, fanouts=(4, 3), **kw)
  out = check_forward_and_grads(jm, params, tm, b, 'zero degree',
                                rows=nseed)
  seg = gtt.models.GAT(F, 8, 3, num_layers=2, heads=2, device='cpu')
  seg.load_state_dict(tm.state_dict())
  t = tdict(b)
  with torch.no_grad():
    ref = seg(t['x'], t['edge_index'], t['edge_mask'])
  close(out[:nseed].numpy(), ref[:nseed].numpy(), 'zero degree vs segment')


def test_tree_gat_refuses_a_truncated_layout():
  """TreeGATConv validates its blocks against the true fanouts: a
  node_budget layout is refused, as in JAX."""
  no, eo = gtt.models.train.tree_hop_offsets(16, [4, 3], node_budget=40)
  m = gtt.models.GAT(F, 8, 4, hop_node_offsets=no, hop_edge_offsets=eo,
                     tree_dense=True, fanouts=(4, 3), device='cpu')
  x = torch.zeros((no[-1], F))
  with pytest.raises(AssertionError, match='un-truncated'):
    m(x, torch.zeros((2, eo[-1]), dtype=torch.int32),
      torch.ones(eo[-1], dtype=torch.bool))


def test_gat_layout_asserts():
  """JAX's layout asserts: dense flags need hop offsets and fanouts and
  exclude each other; a layered model refuses layer slices and a batch
  of another layout."""
  no, eo = gtt.models.train.tree_hop_offsets(16, [4, 3])
  for kw in (dict(tree_dense=True), dict(merge_dense=True),
             dict(hop_node_offsets=no, hop_edge_offsets=eo,
                  tree_dense=True),
             dict(hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=True,
                  merge_dense=True, fanouts=(4, 3))):
    with pytest.raises(AssertionError):
      gtt.models.GAT(F, 8, 4, device='cpu', **kw)
  m = gtt.models.GAT(F, 8, 4, hop_node_offsets=no, hop_edge_offsets=eo,
                     device='cpu')
  ei = torch.zeros((2, eo[-1]), dtype=torch.int32)
  em = torch.ones(eo[-1], dtype=torch.bool)
  with pytest.raises(AssertionError, match='layer slices'):
    m(torch.zeros((no[-1], F)), ei, em, layers=(0, 1))
  with pytest.raises(AssertionError, match='layered GAT'):
    m(torch.zeros((no[-1] + 1, F)), ei, em)


# -------------------------------------------------------- run layouts


def test_run_softmax_and_mean_window_equal_reshape(monkeypatch):
  """RUN_SOFTMAX_IMPL / RUN_MEAN_IMPL = 'window' (the flat layout) equal
  'reshape' at the kernel level (all-masked and underflow-prone runs)
  and through TreeGATConv, MergeGATConv and TreeSAGEConv forwards, both
  equal to flax's (tests/test_models.py:876, :930)."""
  import jax.numpy as jnp
  from graphlearn_tpu.models import models as JM
  assert M.RUN_SOFTMAX_IMPL == M.RUN_MEAN_IMPL == 'reshape'
  rng = np.random.default_rng(0)
  f, k, h = 23, 5, 2
  e = rng.standard_normal((f, k, h)).astype(np.float32) * 10
  e[3] -= 200.0
  m = rng.random((f, k)) < 0.6
  m[5] = False
  x = rng.standard_normal((f * k, 16)).astype(np.float32)
  want_sm = np.asarray(JM._masked_run_softmax(jnp.asarray(e), jnp.asarray(m),
                                              jnp.float32, 0.2))
  want_mean = np.asarray(JM._masked_flat_run_mean(jnp.asarray(x),
                                                  jnp.asarray(m), k))
  tb = {d: tdict(jax_batch(d)) for d in ('tree', 'map')}
  models = {}
  for d, flag in (('tree', 'tree_dense'), ('map', 'merge_dense')):
    models[d] = gtt.models.GAT(F, 8, 4, num_layers=2, heads=2, device='cpu',
                               generator=torch.Generator().manual_seed(1),
                               **{k_: v for k_, v in gat_kw(
                                   d, None, {flag: True}).items()
                                  if k_ not in ('hidden_dim', 'out_dim',
                                                'num_layers', 'heads')})
  no, eo = jtrain.tree_hop_offsets(16, [4, 3])
  models['sage'] = gtt.models.GraphSAGE(
      F, 8, 4, num_layers=2, hop_node_offsets=no, hop_edge_offsets=eo,
      tree_dense=True, fanouts=(4, 3), device='cpu')
  tb['sage'] = tb['tree']
  outs = {}
  for impl in ('reshape', 'window'):
    monkeypatch.setattr(M, 'RUN_SOFTMAX_IMPL', impl)
    monkeypatch.setattr(M, 'RUN_MEAN_IMPL', impl)
    sm = M._masked_run_softmax(torch.as_tensor(e), torch.as_tensor(m),
                               torch.float32, 0.2)
    close(sm.numpy(), want_sm, f'{impl} softmax', atol=1e-6, rtol=1e-5)
    assert not sm[5].any()
    mean = M._masked_flat_run_mean(torch.as_tensor(x), torch.as_tensor(m), k)
    close(mean.numpy(), want_mean, f'{impl} mean', atol=1e-6, rtol=1e-5)
    with torch.no_grad():
      outs[impl] = {name: mdl(tb[name]['x'], tb[name]['edge_index'],
                              tb[name]['edge_mask'])
                    for name, mdl in models.items()}
  for name in models:
    close(outs['window'][name].numpy(), outs['reshape'][name].numpy(),
          f'{name} window vs reshape')


def test_impl_from_env_and_the_decision_rule(monkeypatch):
  """The layout choice reads JAX's environment names (an unknown value
  raises), and run_impl_decision is JAX's rule, word for word
  (tests/test_models.py:987)."""
  from graphlearn_tpu.models.models import run_impl_decision as jdec
  monkeypatch.setenv('GLT_RUN_SOFTMAX_IMPL', 'window')
  assert M._impl_from_env('GLT_RUN_SOFTMAX_IMPL', 'reshape',
                          ('reshape', 'window')) == 'window'
  monkeypatch.setenv('GLT_RUN_SOFTMAX_IMPL', ' ')
  assert M._impl_from_env('GLT_RUN_SOFTMAX_IMPL', 'reshape',
                          ('reshape', 'window')) == 'reshape'
  monkeypatch.setenv('GLT_RUN_SOFTMAX_IMPL', 'flat')
  with pytest.raises(ValueError, match='GLT_RUN_SOFTMAX_IMPL'):
    M._impl_from_env('GLT_RUN_SOFTMAX_IMPL', 'reshape',
                     ('reshape', 'window'))
  dec = gtt.models.run_impl_decision
  assert dec(10.0, 9.0)[0] == 'window'
  assert dec(10.0, 9.9)[0] == 'reshape'
  assert dec(10.0, 10.5)[0] == 'reshape'
  d, why = dec(None, 9.0)
  assert d is None and 'reshape leg' in why
  d, why = dec(10.0, None)
  assert d is None and 'window leg' in why
  assert dec(None, None)[0] is None
  for args in ((10.0, 9.0), (10.0, 9.9), (3.0, 2.0, 0.5), (None, 1.0),
               (None, None)):
    assert dec(*args) == jdec(*args), args


# ------------------------------------------------- bf16, state, training


@pytest.mark.parametrize('forward', ['tree_dense', 'merge_dense'])
def test_gat_bf16_within_output_scale(forward):
  """GAT(dtype=bfloat16): float32 parameters, bfloat16 logits within
  3e-2 of the output's scale of flax's."""
  import jax.numpy as jnp
  dedup, caps, flags = FORWARDS[forward]
  b = jax_batch(dedup, caps)
  jm, params, tm = pair(glt.models.GAT, gtt.models.GAT, b, F,
                        jkw=dict(dtype=jnp.bfloat16),
                        **gat_kw(dedup, caps, flags))
  tm2 = gtt.models.GAT(F, device='cpu', dtype=torch.bfloat16,
                       **gat_kw(dedup, caps, flags))
  tm2.load_state_dict(tm.state_dict())
  want = np.asarray(jm.apply(params, b['x'], b['edge_index'],
                             b['edge_mask']), np.float32)
  t = tdict(b)
  got = tm2(t['x'], t['edge_index'], t['edge_mask'])
  assert got.dtype == torch.bfloat16
  assert all(p.dtype == torch.float32 for p in tm2.parameters())
  scale = np.abs(want).max()
  assert np.abs(got.detach().float().numpy() - want).max() <= 3e-2 * scale


def test_params_round_trip_through_flax():
  """params_to_flax(params_from_flax(p)) is the flax tree again, for GCN
  (``Dense_0``) and the dense GATs."""
  for dedup, flags, cls in (('tree', {}, 'GCN'),
                            ('tree', dict(tree_dense=True), 'GAT'),
                            ('map', dict(merge_dense=True), 'GAT')):
    b = jax_batch(dedup)
    kw = (dict(hidden_dim=8, out_dim=4) if cls == 'GCN' else
          gat_kw(dedup, None, flags))
    _, params, tm = pair(getattr(glt.models, cls), getattr(gtt.models, cls),
                         b, F, **kw)
    back = convert.params_to_flax(convert.params_from_flax(params, tm), tm)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, arr in flat_a:
      np.testing.assert_array_equal(flat_b[path], arr)


@pytest.mark.parametrize('cls,forward', [('GAT', 'tree_dense'),
                                         ('GAT', 'merge_dense_caps'),
                                         ('GCN', 'segment')])
def test_train_step_matches_optax(cls, forward):
  """Two train steps (make_train_step, Adam 3e-3) from flax's parameters
  and optax's state after one step: losses, parameters and Adam moments
  equal optax's (adam_state_from_optax / adam_state_to_optax)."""
  import optax
  dedup, caps, flags = FORWARDS[forward]
  b = jax_batch(dedup, caps)
  kw = (dict(hidden_dim=8, out_dim=4) if cls == 'GCN' else
        gat_kw(dedup, caps, flags))
  jm, params, tm = pair(getattr(glt.models, cls), getattr(gtt.models, cls),
                        b, F, **kw)
  tx = optax.adam(3e-3)
  jstate = jtrain.TrainState(params, tx.init(params), np.zeros((), np.int32))
  jstep, _ = jtrain.make_train_step(jm, tx, 4)
  jstate, jloss0, _ = jstep(jstate, b)
  state = ttrain.create_train_state(tm, lr=3e-3)
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params), tm))
  convert.adam_state_from_optax(
      state.optimizer, tm,
      jax.tree.map(np.asarray, tuple(jstate.opt_state[0])))
  tstep, _ = ttrain.make_train_step(tm, 4)
  jstate, jloss, _ = jstep(jstate, b)
  state, loss, _ = tstep(state, tdict(b))
  close(float(loss), float(jloss), 'loss')
  want = convert.params_from_flax(jax.tree.map(np.asarray, jstate.params),
                                  tm)
  for name, p in tm.named_parameters():
    close(p.detach().numpy(), want[name].numpy(), name, atol=1e-6)
  count, mu, nu = convert.adam_state_to_optax(state.optimizer, tm)
  jcount, jmu, jnu = jax.tree.map(np.asarray, tuple(jstate.opt_state[0]))
  assert count == int(jcount) == 2
  for a, c in ((mu, jmu), (nu, jnu)):
    for (pa, va), (pc, vc) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                  jax.tree_util.tree_flatten_with_path(c)[0]):
      assert pa == pc
      close(va, vc, str(pa), atol=1e-9, rtol=1e-4)


def test_dropout_is_the_module_mode():
  """dropout > 0 (a deliberate difference: torch's dropout stream): in
  train() mode it changes the hidden layer, in eval() mode the model is
  the dropout-free one."""
  b = tdict(jax_batch('tree'))
  args = (b['x'], b['edge_index'], b['edge_mask'])
  for cls in ('GAT', 'GCN'):
    base = getattr(gtt.models, cls)(F, 8, 4, device='cpu')
    drop = getattr(gtt.models, cls)(F, 8, 4, dropout=0.5, device='cpu')
    drop.load_state_dict(base.state_dict())
    with torch.no_grad():
      ref = base(*args)
      drop.eval()
      assert torch.equal(drop(*args), ref)
      drop.train()
      assert not torch.equal(drop(*args), ref)


# ------------------------------------------------------ serving, scan


def test_gat_materializer_matches_jax_and_gcn_is_refused():
  """EmbeddingMaterializer over a segment GAT (2 layers, 2 heads) equals
  JAX's table and refresh rows; GCN is refused in JAX's words, and so is
  a layered GAT."""
  from test_torch_serving import (N, _full_batch, _jax_dataset,
                                  _torch_dataset)
  from graphlearn_tpu.serving import EmbeddingMaterializer as JMat
  from graphlearn_tpu_torch.serving import EmbeddingMaterializer
  jds, tds = _jax_dataset(), _torch_dataset()
  x, ei, em = _full_batch(jds.graph.topo, jds.node_features.feature_array)
  jm = glt.models.GAT(hidden_dim=4, out_dim=3, num_layers=2, heads=2)
  params = jm.init(jax.random.PRNGKey(0), x, ei, em)
  jmat = JMat(jds, jm, params, block_size=16, chunk_size=4)
  want = np.asarray(jmat.materialize())
  tm = gtt.models.GAT(x.shape[1], 4, 3, num_layers=2, heads=2, device='cpu')
  tm.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray,
                                                           params), tm))
  tmat = EmbeddingMaterializer(tds, tm.eval(), block_size=16, chunk_size=4)
  got = tmat.materialize().numpy()
  close(got[:N], want[:N], 'gat table')
  direct = np.asarray(jm.apply(params, x, ei, em))
  close(got[:N], direct, 'gat table vs the direct forward')
  stale = np.array([0, 3, 41, N - 1])
  close(tmat.refresh_rows(stale), jmat.refresh_rows(stale), 'gat refresh')
  gcn = glt.models.GCN(hidden_dim=4, out_dim=3)
  with pytest.raises(ValueError, match='GCN') as jerr:
    JMat(jds, gcn, gcn.init(jax.random.PRNGKey(0), x, ei, em))
  with pytest.raises(ValueError, match='GCN') as terr:
    EmbeddingMaterializer(tds, gtt.models.GCN(x.shape[1], 4, 3,
                                              device='cpu'))
  assert str(terr.value) == str(jerr.value)
  no, eo = gtt.sampler.tree_layout(4, [2])
  layered = gtt.models.GAT(x.shape[1], 4, 3, num_layers=1,
                           hop_node_offsets=no, hop_edge_offsets=eo,
                           tree_dense=True, fanouts=[2], device='cpu')
  with pytest.raises(ValueError, match='GAT'):
    EmbeddingMaterializer(tds, layered)


def test_scan_trainer_takes_a_tree_dense_gat():
  """A ScanTrainer epoch of a tree-dense GAT replays the per-step loop
  exactly (losses and parameters), as the SAGE one does
  (tests/test_torch_scan.py)."""
  from test_torch_scan import C, _port_loader
  from test_torch_scan import F as SF
  no, eo = ttrain.tree_hop_offsets(8, [3, 2])

  def model():
    return gtt.models.GAT(SF, 8, C, num_layers=2, heads=2,
                          hop_node_offsets=no, hop_edge_offsets=eo,
                          tree_dense=True, fanouts=(3, 2), device='cpu',
                          generator=torch.Generator().manual_seed(0))

  ref_model = model()
  m = copy.deepcopy(ref_model)
  loop_loader = _port_loader(44, dedup='tree')
  ref_state = ttrain.create_train_state(ref_model)
  step, _ = ttrain.make_train_step(ref_model, C)
  ref_losses = []
  for batch in loop_loader:
    ref_state, loss, _ = step(ref_state, ttrain.batch_to_dict(batch))
    ref_losses.append(loss)
  trainer = gtt.loader.ScanTrainer(_port_loader(44, dedup='tree'), m, C,
                                   chunk_size=4)
  state, losses, _ = trainer.run_epoch(ttrain.create_train_state(m))
  assert state.step == len(ref_losses) == 6
  assert torch.equal(losses, torch.stack(ref_losses))
  for a, b in zip(ref_model.parameters(), m.parameters()):
    assert torch.equal(a, b)


@pytest.mark.parametrize('cls', ['GAT', 'GCN'])
def test_link_and_eval_steps_over_gat_and_gcn_match_jax(cls):
  """The link step (dot-product scores, sigmoid cross-entropy; pairs with
  a -1 excluded) and the eval counts over GAT (tree-dense) and GCN: the
  loss, the accuracy and the gradients equal JAX's
  (``make_link_train_step``'s loss, ``make_eval_counts``)."""
  dedup, caps, flags = FORWARDS['tree_dense' if cls == 'GAT' else 'segment']
  b = jax_batch(dedup, caps)
  kw = (dict(hidden_dim=8, out_dim=4) if cls == 'GCN' else
        gat_kw(dedup, caps, flags))
  jm, params, tm = pair(getattr(glt.models, cls), getattr(gtt.models, cls),
                        b, F, **kw)
  rng = np.random.default_rng(6)
  rows = 80 if cls == 'GAT' else b['x'].shape[0]   # the output's rows
  eli = rng.integers(0, rows, (2, 24)).astype(np.int32)
  eli[:, -3:] = -1
  lb = dict(b, edge_label_index=eli,
            edge_label=(rng.random(24) < 0.5).astype(np.float32))
  import optax
  tx = optax.adam(3e-3)
  jstate = jtrain.TrainState(params, tx.init(params), np.zeros((), np.int32))
  jstep, jeval = jtrain.make_link_train_step(jm, tx)
  jacc = float(jeval(jstate, lb))
  _, jloss, _ = jstep(jstate, lb)
  loss_fn = ttrain.make_link_loss_fn(tm)
  loss, acc = loss_fn(tdict(lb))
  close(float(loss), float(jloss), 'link loss')
  close(float(acc), jacc, 'link acc')
  import jax.numpy as jnp
  valid = (eli[0] >= 0) & (eli[1] >= 0)

  def jlink(p):     # make_link_train_step's loss, for its gradients
    h = jm.apply(p, b['x'], b['edge_index'], b['edge_mask'])
    score = (h[np.maximum(eli[0], 0)] * h[np.maximum(eli[1], 0)]).sum(-1)
    bce = optax.sigmoid_binary_cross_entropy(score, lb['edge_label'])
    return jnp.where(valid, bce, 0.0).sum() / valid.sum()

  close(float(jlink(params)), float(jloss), 'link loss (reference)')
  loss.backward()
  grads_match(tm, jax.tree.map(np.asarray, jax.grad(jlink)(params)), 'link')
  jcorrect, jtotal = jtrain.make_eval_counts(jm)(params, b)
  correct, total = ttrain.make_eval_counts(tm)(tdict(b))
  assert (int(correct), int(total)) == (int(jcorrect), int(jtotal))
