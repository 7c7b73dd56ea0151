"""The port's HGT against flax: ``HGTConv`` (an absent node type, the
segment softmax) and the ``HGT`` stack in its segment, hierarchical,
tree-dense and merge-dense (calibrated caps and none) forwards, outputs
and gradients with the flax parameters carried by ``models.convert``;
the forwards against each other, bf16, the parameters and Adam state
through flax / optax and a typed train step against optax.

Batches come from the JAX package's typed loader over the small
paper/author/topic graph of tests/test_torch_hetero_sampler.py, at
width 8 with 2 heads. Float outputs agree within atol 1e-5, rtol 1e-4,
bf16 within 3e-2 of the output's scale. Mirrors tests/test_models.py:244,
:402, :546, :726, :1005.
"""
import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain
from test_torch_hetero_models import (FAN, MSG_ETYPES, _check_forward_and_grads,
                                      close, jax_batch, jax_dataset,
                                      torch_inputs)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

NTYPES = ('paper', 'author', 'topic')


def layout(mode):
  """``(batch, kw)``: a typed batch of the mode's engine and the HGT
  layout arguments of the forward ('segment', 'hierarchical', 'tree',
  'merge' with calibrated caps, 'merge_nocaps')."""
  caps = None
  if mode == 'merge':
    caps = glt.sampler.estimate_hetero_frontier_caps(
        jax_dataset().graph, FAN, {'paper': 8}, num_probes=6, slack=1.5,
        multiple=4)
  batch = jax_batch('merge' if mode.startswith('merge') else 'tree', caps)
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN, etype_caps=caps)
  assert (recs, no, eo) == gtt.sampler.hetero_tree_blocks(
      {'paper': 8}, tuple(FAN), FAN, etype_caps=caps)
  kw = {}
  if mode != 'segment':
    kw = dict(hop_node_offsets=no, hop_edge_offsets=eo)
  if mode in ('tree', 'merge', 'merge_nocaps'):
    kw['tree_records'] = recs
  if mode.startswith('merge'):
    kw['merge_dense'] = True
  return batch, kw


def hgt_pair(x, ei, em, jkw=None, **kw):
  """(flax HGT, its params, the port's HGT carrying them), hidden 8, 2
  heads, 2 layers, 3 classes on 'paper'."""
  in_dims = {t: v.shape[1] for t, v in x.items()}
  mk = dict(hidden_dim=8, out_dim=3, heads=2, num_layers=2,
            out_ntype='paper')
  jm = glt.models.HGT(ntypes=NTYPES, etypes=MSG_ETYPES, in_dims=in_dims,
                      **mk, **(jkw or {}), **kw)
  params = jax.tree.map(np.asarray, jax.jit(jm.init)(
      jax.random.PRNGKey(0), x, ei, em))
  tm = gtt.models.HGT(NTYPES, MSG_ETYPES, in_dims=in_dims, device='cpu',
                      **mk, **kw)
  sd = convert.params_from_flax(params, tm)
  assert set(sd) == set(dict(tm.named_parameters()))
  tm.load_state_dict(sd)
  return jm, params, tm


def test_hgt_conv_absent_type_matches_flax():
  """HGTConv builds every metadata type's parameters at init: flax's
  tree initialised without type 'a' loads into it, and a batch with both
  types gives flax's output (tests/test_models.py:244); a batch without
  'a' gives 'b' alone. An input width other than out_dim skips the
  gated residual."""
  from graphlearn_tpu.models.hgt import HGTConv as JHGTConv
  rng = np.random.default_rng(0)
  meta = (['a', 'b'], [('a', 'r', 'b'), ('b', 'r2', 'b')])
  xa = rng.standard_normal((5, 8)).astype(np.float32)
  xb = rng.standard_normal((4, 8)).astype(np.float32)
  ei = np.array([[0, 1, 4, 2, -1, 3], [0, 3, 3, 1, -1, 2]], np.int32)
  em = np.array([True, True, True, False, False, True])
  ei2 = np.array([[0, 1, 2], [1, 1, 3]], np.int32)
  em2 = np.ones(3, bool)
  jc = JHGTConv(out_dim=8, metadata=meta, heads=2)
  params = jax.tree.map(np.asarray, jc.init(
      jax.random.PRNGKey(0), {'b': xb}, {}, {}))
  tc = gtt.models.HGTConv(8, meta, heads=2)
  tc.load_state_dict(convert.params_from_flax(params, tc))
  xs = {'a': xa, 'b': xb}
  eis = {meta[1][0]: ei, meta[1][1]: ei2}
  ems = {meta[1][0]: em, meta[1][1]: em2}
  want = jc.apply(params, xs, eis, ems)
  got = tc(*torch_inputs(xs, eis, ems))
  assert set(got) == {'a', 'b'}
  for t in got:
    close(got[t].detach().numpy(), np.asarray(want[t]), t)
  only_b = tc(*torch_inputs({'b': xb}, {}, {}))
  assert set(only_b) == {'b'}
  close(only_b['b'].detach().numpy(),
        np.asarray(jc.apply(params, {'b': xb}, {}, {})['b']), 'b alone')
  # an input width other than out_dim: no skip (in_dims names it)
  jc6 = JHGTConv(out_dim=8, metadata=meta, heads=2, in_dims={'a': 6})
  xa6 = xa[:, :6]
  p6 = jax.tree.map(np.asarray, jc6.init(
      jax.random.PRNGKey(1), {'a': xa6, 'b': xb}, eis, ems))
  tc6 = gtt.models.HGTConv(8, meta, heads=2, in_dims={'a': 6})
  tc6.load_state_dict(convert.params_from_flax(p6, tc6))
  want6 = jc6.apply(p6, {'a': xa6, 'b': xb}, eis, ems)
  got6 = tc6(*torch_inputs({'a': xa6, 'b': xb}, eis, ems))
  for t in got6:
    close(got6[t].detach().numpy(), np.asarray(want6[t]), f'{t} in_dims')


@pytest.mark.parametrize('mode', ['segment', 'hierarchical', 'tree',
                                  'merge', 'merge_nocaps'])
def test_hgt_forwards_match_flax(mode):
  """HGT's segment, hierarchical, tree-dense and merge-dense forwards
  (tests/test_models.py:546, :726, :1005): outputs and gradients equal
  flax's with the same parameters."""
  (x, ei, em, nseed), kw = layout(mode)
  jm, params, tm = hgt_pair(x, ei, em, **kw)
  _check_forward_and_grads(jm, params, tm, x, ei, em, nseed, f'hgt {mode}')


@pytest.mark.parametrize('kind', ['tree', 'merge', 'merge_nocaps'])
def test_hgt_forwards_agree_with_each_other(kind):
  """With one set of weights, the seed logits of the dense forward equal
  the segment forward's on the same batch, and those of the hierarchical
  forward the full one's (tests/test_models.py:546, :726, :1005)."""
  (x, ei, em, nseed), kw = layout(kind)
  in_dims = {t: v.shape[1] for t, v in x.items()}
  gen = torch.Generator().manual_seed(3)
  seg = gtt.models.HGT(NTYPES, MSG_ETYPES, 8, 3, heads=2, out_ntype='paper',
                       in_dims=in_dims, device='cpu', generator=gen)
  outs = {}
  variants = {'dense': kw, 'hierarchical': dict(
      hop_node_offsets=kw['hop_node_offsets'],
      hop_edge_offsets=kw['hop_edge_offsets'])}
  inputs = torch_inputs(x, ei, em)
  with torch.no_grad():
    ref = seg(*inputs)
    for name, vkw in variants.items():
      m = gtt.models.HGT(NTYPES, MSG_ETYPES, 8, 3, heads=2,
                         out_ntype='paper', in_dims=in_dims, device='cpu',
                         **vkw)
      m.load_state_dict(seg.state_dict())
      outs[name] = m(*inputs)
  assert outs['dense'].shape[0] == 8
  close(outs['dense'][:nseed].numpy(), ref[:nseed].numpy(),
        f'{kind} dense vs segment', atol=2e-5, rtol=2e-4)
  close(outs['hierarchical'][:nseed].numpy(), ref[:nseed].numpy(),
        f'{kind} hierarchical vs full', atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('mode', ['segment', 'tree'])
def test_hgt_bf16_within_output_scale(mode):
  """HGT(dtype=bfloat16) (tests/test_models.py:402): float32 parameters,
  bfloat16 logits within 3e-2 of the output's scale of flax's (logits and
  softmax stay float32)."""
  import jax.numpy as jnp
  (x, ei, em, _), kw = layout(mode)
  jm, params, tm = hgt_pair(x, ei, em, jkw=dict(dtype=jnp.bfloat16), **kw)
  t16 = gtt.models.HGT(NTYPES, MSG_ETYPES, 8, 3, heads=2, out_ntype='paper',
                       in_dims={t: v.shape[1] for t, v in x.items()},
                       dtype=torch.bfloat16, device='cpu', **kw)
  t16.load_state_dict(tm.state_dict())
  want = np.asarray(jm.apply(params, x, ei, em), np.float32)
  got = t16(*torch_inputs(x, ei, em))
  assert got.dtype == torch.bfloat16
  assert all(p.dtype == torch.float32 for p in t16.parameters())
  scale = np.abs(want).max()
  assert np.abs(got.detach().float().numpy() - want).max() <= 3e-2 * scale


def test_hgt_params_round_trip_through_flax():
  """params_to_flax(params_from_flax(p)) is flax's HGT tree again
  (``lin_{t}``, ``head``, ``conv{i}/{k,q,v,a}_{t}``, ``skip_{t}``,
  ``conv{i}/{att,msg,pri}_{src__rel__dst}``)."""
  (x, ei, em, _), kw = layout('tree')
  _, params, tm = hgt_pair(x, ei, em, **kw)
  assert set(params['params']) == {'lin_paper', 'lin_author', 'lin_topic',
                                   'head', 'conv0', 'conv1'}
  assert set(params['params']['conv0']) == \
      {f'{p}_{t}' for p in ('k', 'q', 'v', 'a', 'skip') for t in NTYPES} | \
      {f'{p}_{"__".join(et)}' for p in ('att', 'msg', 'pri')
       for et in MSG_ETYPES}
  back = convert.params_to_flax(convert.params_from_flax(params, tm), tm)
  flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
  flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
  assert len(flat_a) == len(flat_b)
  for path, arr in flat_a:
    np.testing.assert_array_equal(flat_b[path], arr)


@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_hgt_train_step_matches_optax(mode):
  """A typed train step (batch_to_dict's typed dict, Adam 3e-3) from
  flax's parameters and optax's state after one step: the loss and the
  gradients equal JAX's, and Adam on JAX's gradients gives optax's
  parameters and moments. (The key projections' biases get gradients at
  rounding level in JAX, 0 in exact arithmetic: a softmax does not see a
  constant added to every logit of a target. The port's are exactly 0.
  Adam scales JAX's noise up to a step of its own, so the update is held
  on common gradients.)"""
  import optax
  from test_torch_hetero_models import grads_match
  (x, ei, em, nseed), kw = layout(mode)
  jm, params, tm = hgt_pair(x, ei, em, **kw)
  y = np.random.default_rng(5).integers(0, 3, x['paper'].shape[0])
  jb = dict(x=x, edge_index=ei, edge_mask=em, y=y, num_seed_nodes=nseed)
  tx = optax.adam(3e-3)
  jstate = jtrain.TrainState(params, tx.init(params), np.zeros((), np.int32))
  jstep, _ = jtrain.make_train_step(jm, tx, 3)
  jstate, _, _ = jstep(jstate, jb)
  state = ttrain.create_train_state(tm, lr=3e-3)
  tm.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jstate.params), tm))
  convert.adam_state_from_optax(
      state.optimizer, tm, jax.tree.map(np.asarray,
                                        tuple(jstate.opt_state[0])))
  (jloss, _), jgrads = jax.value_and_grad(
      jtrain.make_loss_fn(jm, 3), has_aux=True)(jstate.params, jb)
  jgrads = jax.tree.map(np.asarray, jgrads)
  tx_, tei, tem = torch_inputs(x, ei, em)
  tb = dict(x=tx_, edge_index=tei, edge_mask=tem, y=torch.as_tensor(y),
            num_seed_nodes=torch.tensor(nseed))
  state.optimizer.zero_grad()
  loss, _ = ttrain.make_loss_fn(tm, 3)(tb)
  loss.backward()
  close(float(loss), float(jloss), 'loss')
  grads_match(tm, jgrads, f'hgt {mode} step')
  keys = [p for name, p in tm.named_parameters() if _key_bias(name)]
  assert keys and all(p.grad is not None and not p.grad.any() for p in keys)
  common = convert.params_from_flax(jgrads, tm)
  for name, p in tm.named_parameters():
    p.grad = common[name].clone()
  state.optimizer.step()
  updates, opt_state = tx.update(jgrads, jstate.opt_state, jstate.params)
  want = convert.params_from_flax(
      jax.tree.map(np.asarray, optax.apply_updates(jstate.params, updates)),
      tm)
  for name, p in tm.named_parameters():
    close(p.detach().numpy(), want[name].numpy(), name, atol=1e-7)
  count, mu, nu = convert.adam_state_to_optax(state.optimizer, tm)
  jcount, jmu, jnu = jax.tree.map(np.asarray, tuple(opt_state[0]))
  assert count == int(jcount) == 2
  for a, c in ((mu, jmu), (nu, jnu)):
    flat = dict(jax.tree_util.tree_flatten_with_path(a)[0])
    for path, arr in jax.tree_util.tree_flatten_with_path(c)[0]:
      close(flat[path], arr, str(path), atol=1e-9, rtol=1e-4)


def _key_bias(name):
  return name.split('.')[-2].startswith('k_') and name.endswith('.bias')


def test_hgt_key_bias_takes_zero_moments():
  """The port's own steps (no common gradients): a key projection's bias
  gets an exact 0 gradient, stays where it was, and carries zero Adam
  moments into optax's layout (JAX's moments there are rounding noise,
  the one deliberate difference of an HGT state); optax's state taken up
  mid-run steps every parameter, so it goes back out at one count."""
  (x, ei, em, nseed), kw = layout('tree')
  in_dims = {t: v.shape[1] for t, v in x.items()}
  tm = gtt.models.HGT(NTYPES, MSG_ETYPES, 8, 3, heads=2, num_layers=2,
                      in_dims=in_dims, out_ntype='paper', device='cpu',
                      generator=torch.Generator().manual_seed(0), **kw)
  y = np.random.default_rng(5).integers(0, 3, x['paper'].shape[0])
  tx_, tei, tem = torch_inputs(x, ei, em)
  tb = dict(x=tx_, edge_index=tei, edge_mask=tem, y=torch.as_tensor(y),
            num_seed_nodes=torch.tensor(nseed))
  before = {n: p.detach().clone() for n, p in tm.named_parameters()}
  state = ttrain.create_train_state(tm, lr=3e-3)
  step, _ = ttrain.make_train_step(tm, 3)
  for _ in range(2):
    state, _, _ = step(state, tb)
  count, mu, nu = convert.adam_state_to_optax(state.optimizer, tm)
  assert count == 2
  assert 'conv0.k_paper.bias' in before
  moved = [n for n, p in tm.named_parameters()
           if not torch.equal(p.detach(), before[n])]
  assert moved and not any(_key_bias(n) for n in moved), moved
  for tree in (mu, nu):
    flat = convert.params_from_flax(tree, tm)
    keys = [n for n in flat if _key_bias(n)]
    assert keys, 'no key bias carries Adam state'
    assert all(not flat[n].any() for n in keys), keys
    assert any(flat[n].any() for n in flat if not _key_bias(n))
  taken = (count, jax.tree.map(lambda a: a + 1e-3, mu),
           jax.tree.map(lambda a: a + 1e-6, nu))
  convert.adam_state_from_optax(state.optimizer, tm, taken)
  state, _, _ = step(state, tb)
  assert convert.adam_state_to_optax(state.optimizer, tm)[0] == 3


def test_hgt_needs_in_dims():
  with pytest.raises(ValueError, match='in_dims'):
    gtt.models.HGT(NTYPES, MSG_ETYPES, 8, 3, device='cpu')
