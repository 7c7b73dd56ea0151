"""bfloat16 compute, the layered segment forward and the products
example's other modes, against flax, optax and the JAX example, on the
CPU.

- ``SAGEConv``, ``TreeSAGEConv``, ``MergeSAGEConv`` and ``GraphSAGE``
  with ``dtype=torch.bfloat16`` against the flax modules with
  ``dtype=jnp.bfloat16`` on the same (converted) float32 weights. bf16
  keeps 8 significant bits (a relative step of 2**-8 to 2**-7), and the
  two frameworks round at different places (torch's CPU kernels sum a
  bf16 reduction or product in float32 and round once; XLA rounds its
  own way, and the gathers and means round in between), so outputs
  agree within ``BF16_TOL`` of the output's scale: a few bf16 steps
  after three layers, and far below the spread of the outputs.
- ``convert`` carries the JAX parameters across as float32 under a bf16
  model, and the gradients and Adam's moments stay float32.
- The layered segment forward (hop offsets, no dense flag: what
  node_budget-truncated tree batches take) against flax in float32,
  within atol 1e-5, rtol 1e-4.
- The example's per-step losses (shuffle=False, 3 steps crossing an
  epoch boundary, so the padded window is reseeded once) for each new
  flag, against the JAX example's steps: float32 modes within rtol 1e-4,
  bf16 modes within ``BF16_TOL``.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import models as jmodels
from graphlearn_tpu.models import conv as jconv
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.examples import train_sage_products as example
from graphlearn_tpu_torch.models import conv as tconv
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import models as tmodels
from graphlearn_tpu_torch.models import train as ttrain

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

BF16_TOL = 3e-2   # of the output's largest magnitude (see the docstring)


def _close_bf16(got, ref):
  got = got.detach().float().numpy()
  ref = np.asarray(ref, np.float32)
  scale = float(np.abs(ref).max())
  np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_TOL * scale)


def _jax_batch(fanouts, batch, dedup='tree', node_budget=None, n=250, f=12,
               c=6):
  rng = np.random.default_rng(len(fanouts))
  ei = rng.integers(0, n, (2, 3000))
  ds = glt.data.Dataset()
  ds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  ds.init_node_features(rng.standard_normal((n, f)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, c, n).astype(np.int32))
  loader = glt.loader.NeighborLoader(ds, fanouts, np.arange(batch - 3),
                                     batch_size=batch, dedup=dedup, seed=2,
                                     node_budget=node_budget)
  return jtrain.batch_to_dict(next(iter(loader))), f, c


def _torch(jd):
  return {k: torch.as_tensor(np.array(v)) for k, v in jd.items()}


def _load_conv(tmod, params):
  """flax ``{'lin_self': {kernel, bias}, 'lin_nbr': {kernel}}`` -> a
  torch conv's state."""
  sd = {k.split('.', 1)[1]: v for k, v in convert.params_from_flax(
      {'conv': jax.tree.map(np.asarray, params['params'])}).items()}
  tmod.load_state_dict(sd)


def test_sage_conv_bf16_matches_flax():
  rng = np.random.default_rng(0)
  n, f, e = 60, 16, 400
  x = rng.standard_normal((n, f)).astype(np.float32)
  ei = rng.integers(-1, n, (2, e)).astype(np.int32)
  em = rng.random(e) < 0.9
  for aggr in ('mean', 'sum', 'max'):
    jm = jconv.SAGEConv(24, aggr=aggr, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), x, ei, em)
    ref = jm.apply(p, x, ei, em)
    tm = tconv.SAGEConv(f, 24, aggr=aggr, dtype=torch.bfloat16)
    _load_conv(tm, p)
    got = tm(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close_bf16(got, ref)


@pytest.mark.parametrize('kind', ['tree', 'merge'])
def test_dense_convs_bf16_match_flax(kind):
  fanouts, batch = [3, 2], 8
  jd, f, _ = _jax_batch(fanouts, batch, dedup=kind)
  td = _torch(jd)
  if kind == 'tree':
    no, _ = jtrain.tree_hop_offsets(batch, fanouts)
    jm = jmodels.TreeSAGEConv(20, node_offsets=no, fanouts=tuple(fanouts),
                              dtype=jnp.bfloat16, out_rows=no[1])
    args = (jd['x'], jd['edge_mask'])
    targs = (td['x'], td['edge_mask'])
    tm = tmodels.TreeSAGEConv(f, 20, no, fanouts, out_rows=no[1],
                              dtype=torch.bfloat16)
  else:
    _, eo = jtrain.merge_hop_offsets(batch, fanouts)
    jm = jmodels.MergeSAGEConv(20, edge_offsets=eo, fanouts=tuple(fanouts),
                               dtype=jnp.bfloat16)
    args = (jd['x'], jd['edge_index'], jd['edge_mask'])
    targs = (td['x'], td['edge_index'], td['edge_mask'])
    tm = tmodels.MergeSAGEConv(f, 20, eo, fanouts, dtype=torch.bfloat16)
  p = jm.init(jax.random.PRNGKey(3), *args)
  ref = jm.apply(p, *args)
  _load_conv(tm, p)
  got = tm(*targs)
  assert got.dtype == torch.bfloat16 and got.shape == ref.shape
  _close_bf16(got, ref)


def _models(fanouts, batch, mode, dtype_pair, node_budget=None, aggr='mean'):
  """(jax model, torch model, params, jax batch, torch batch)."""
  jd, f, c = _jax_batch(fanouts, batch, dedup='tree' if mode != 'merge'
                        else 'merge', node_budget=node_budget)
  jdt, tdt = dtype_pair
  if mode == 'merge':
    no, eo = jtrain.merge_hop_offsets(batch, fanouts, node_budget)
    flags = dict(merge_dense=True)
  else:
    no, eo = jtrain.tree_hop_offsets(batch, fanouts, node_budget)
    flags = dict(tree_dense=True) if mode == 'tree' else {}
  layers = len(fanouts)
  jm = JaxSAGE(hidden_dim=32, out_dim=c, num_layers=layers,
               hop_node_offsets=no, hop_edge_offsets=eo, dtype=jdt,
               fanouts=tuple(fanouts), aggr=aggr, **flags)
  params = jm.init(jax.random.PRNGKey(1), jd['x'], jd['edge_index'],
                   jd['edge_mask'])
  tm = gtt.models.GraphSAGE(f, 32, c, num_layers=layers,
                            hop_node_offsets=no, hop_edge_offsets=eo,
                            fanouts=fanouts, device='cpu', dtype=tdt,
                            aggr=aggr, **flags)
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  return jm, tm, params, jd, _torch(jd)


@pytest.mark.parametrize('mode', ['tree', 'merge', 'segment'])
def test_graphsage_bf16_matches_flax(mode):
  jm, tm, params, jd, td = _models([4, 3, 2], 8, mode,
                                   (jnp.bfloat16, torch.bfloat16))
  ref = jtrain.make_forward_fn(jm)(params, jd)
  got = ttrain.make_forward_fn(tm)(td)
  assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
  assert got.shape == ref.shape
  _close_bf16(got, ref)
  # the parameters stay float32, and so do the gradients and Adam's state
  assert all(p.dtype == torch.float32 for p in tm.parameters())
  state = ttrain.create_train_state(tm, lr=1e-2)
  step, _ = ttrain.make_train_step(tm, int(jd['y'].max()) + 1)
  state, loss, _ = step(state, td)
  assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
  for p in tm.parameters():
    assert p.dtype == p.grad.dtype == torch.float32
    st = state.optimizer.state[p]
    assert st['exp_avg'].dtype == st['exp_avg_sq'].dtype == torch.float32


def test_convert_keeps_flax_params_float32_under_bf16():
  jm, tm, params, _, _ = _models([3, 2], 8, 'tree',
                                 (jnp.bfloat16, torch.bfloat16))
  flat = jax.tree_util.tree_leaves(params)
  assert all(np.asarray(a).dtype == np.float32 for a in flat)
  back = convert.params_to_flax(tm.state_dict())
  for a, b in zip(jax.tree_util.tree_leaves(params),
                  jax.tree_util.tree_leaves(back)):
    assert b.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize('aggr', ['mean', 'sum', 'max'])
@pytest.mark.parametrize('budget', [None, 20, 70])
def test_layered_segment_forward_matches_flax(budget, aggr):
  jm, tm, params, jd, td = _models([4, 3, 2], 8, 'segment', (None, None),
                                   node_budget=budget, aggr=aggr)
  ref = np.asarray(jtrain.make_forward_fn(jm)(params, jd))
  with torch.no_grad():
    got = ttrain.make_forward_fn(tm)(td).numpy()
  assert got.shape == ref.shape
  np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_layered_forward_refuses_a_mismatched_batch():
  _, tm, _, _, td = _models([4, 3], 8, 'segment', (None, None),
                            node_budget=20)
  no, eo = ttrain.tree_hop_offsets(8, [4, 3])   # no budget: other layout
  wrong = gtt.models.GraphSAGE(12, 32, 6, num_layers=2, hop_node_offsets=no,
                               hop_edge_offsets=eo, device='cpu')
  with pytest.raises(AssertionError, match='do not match'):
    ttrain.make_forward_fn(wrong)(td)


# ----------------------------------------------- the example, per flag

FLAGS = {
    'block': dict(strategy='block'),
    'padded_window': dict(padded_window=8),
    'node_budget_tree': dict(node_budget=60),
    'node_budget_merge': dict(node_budget=60, dedup='map'),
    'bf16_features': dict(bf16_features=True),
    'bf16_model': dict(bf16_model=True),
    'bf16_both_merge': dict(bf16_features=True, bf16_model=True,
                            dedup='map'),
}


def _args(**kw):
  base = dict(batch_size=16, fanout=[4, 3], hidden=32, lr=3e-3, seed=1,
              dedup='tree', strategy='random', padded_window=None,
              node_budget=None, bf16_features=False, bf16_model=False)
  base.update(kw)
  return argparse.Namespace(**base)


def _jax_example_steps(args, ei, feat, label, train_idx, ncls, steps):
  """The JAX example's loader, model and train step (its lines 263-317),
  shuffle=False; the init template comes from a throwaway loader, so the
  training loader's stream starts where the port's does."""
  ds = glt.data.Dataset()
  ds.init_graph(ei, num_nodes=feat.shape[0], graph_mode='HBM')
  ds.init_node_features(
      feat, dtype=(jnp.bfloat16 if args.bf16_features else None))
  ds.init_node_labels(label)

  def loader():
    return glt.loader.NeighborLoader(
        ds, args.fanout, train_idx, batch_size=args.batch_size,
        shuffle=False, drop_last=True, seed=args.seed, dedup=args.dedup,
        strategy=args.strategy, node_budget=args.node_budget,
        padded_window=args.padded_window)

  mdtype = jnp.bfloat16 if args.bf16_model else None
  depth = len(args.fanout)
  if args.dedup == 'tree':
    no, eo = jtrain.tree_hop_offsets(args.batch_size, args.fanout,
                                     args.node_budget)
    model = JaxSAGE(hidden_dim=args.hidden, out_dim=ncls, num_layers=depth,
                    hop_node_offsets=no, hop_edge_offsets=eo, dtype=mdtype,
                    tree_dense=args.node_budget is None,
                    fanouts=tuple(args.fanout))
  else:
    no, eo = jtrain.merge_hop_offsets(args.batch_size, args.fanout,
                                      args.node_budget, None)
    model = JaxSAGE(hidden_dim=args.hidden, out_dim=ncls, num_layers=depth,
                    hop_node_offsets=no, hop_edge_offsets=eo, dtype=mdtype,
                    merge_dense=True, fanouts=tuple(args.fanout))
  first = jtrain.batch_to_dict(next(iter(loader())))
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(args.seed),
                                        first, lr=args.lr)
  params0 = jax.tree.map(np.asarray, state.params)
  step, _ = jtrain.make_train_step(model, tx, ncls)
  losses = []
  ld = loader()
  while len(losses) < steps:
    for batch in ld:
      state, loss, _ = step(state, jtrain.batch_to_dict(batch))
      losses.append(float(loss))
      if len(losses) == steps:
        break
  return params0, np.asarray(losses), ld


@pytest.mark.parametrize('flag', sorted(FLAGS))
def test_example_losses_track_the_jax_example(flag):
  args = _args(**FLAGS[flag])
  rng = np.random.default_rng(0)
  ei, feat, label, train_idx, _, _, ncls = example.make_synthetic(
      500, 10, 7, 12, 0.6, 0.5, rng)
  train_idx = train_idx[:2 * args.batch_size]      # 2 steps an epoch
  steps = 3
  params0, jlosses, jloader = _jax_example_steps(args, ei, feat, label,
                                                 train_idx, ncls, steps)
  ds = gtt.data.Dataset(device='cpu')
  ds.init_graph(ei, num_nodes=feat.shape[0])
  ds.init_node_features(
      feat, dtype=torch.bfloat16 if args.bf16_features else None)
  ds.init_node_labels(label)
  loader = example.make_loader(gtt, ds, args, train_idx, False, args.seed,
                               None, 'cpu')
  model = example.build_model(gtt, args, feat.shape[1], ncls, None, 'cpu',
                              None)
  model.load_state_dict(convert.params_from_flax(params0))
  state = ttrain.create_train_state(model, lr=args.lr)
  step, _ = ttrain.make_train_step(model, ncls)
  losses = []
  while len(losses) < steps:
    for batch in loader:
      state, loss, _ = step(state, ttrain.batch_to_dict(batch))
      losses.append(float(loss))
      if len(losses) == steps:
        break
  assert loader.sampler._call_count == jloader.sampler._call_count
  if args.padded_window is not None:
    assert loader.sampler._padded_seed == jloader.sampler._padded_seed == \
        args.seed + 1
  if args.bf16_model or args.bf16_features:
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_TOL, atol=0)
  else:
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
