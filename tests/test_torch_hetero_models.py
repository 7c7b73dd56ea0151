"""The port's typed models against flax: GATConv, HeteroConv,
TreeHeteroConv (tree and merge, sage and gat) and RGNN in its segment,
hierarchical, tree-dense and merge-dense forwards, outputs and gradients,
with the parameters carried from flax by ``models.convert``.

Batches come from the JAX package's typed loader (tree and calibrated
merge) over a small paper/author/topic graph; the port's dense forwards
are also held to its own segment forward, as tests/test_models.py holds
JAX's.
"""
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu_torch.models import convert
from test_torch_hetero_sampler import CITES, REV, SIZES, TAG, WRITES, \
    typed_edges

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
FAN = {CITES: [2, 2], WRITES: [2, 1], REV: [2, 1], TAG: [1, 0]}
MSG_ETYPES = tuple(glt.typing.reverse_edge_type(et) for et in FAN)


def jax_dataset():
  edges, num_nodes, _ = typed_edges()
  rng = np.random.default_rng(7)
  ds = glt.data.Dataset(edge_dir='out')
  ds.init_graph(edges, graph_mode='CPU', num_nodes=num_nodes)
  ds.init_node_features({t: rng.standard_normal((n, 6)).astype(np.float32)
                         for t, n in SIZES.items()})
  ds.init_node_labels({'paper': rng.integers(0, 3, SIZES['paper'])})
  return ds


def jax_batch(dedup, caps=None, batch_size=8, seeds=None):
  ds = jax_dataset()
  seeds = np.arange(SIZES['paper']) if seeds is None else seeds
  loader = glt.loader.NeighborLoader(ds, FAN, ('paper', seeds),
                                     batch_size=batch_size, seed=0,
                                     dedup=dedup, frontier_caps=caps)
  b = next(iter(loader))
  x = {t: np.asarray(v) for t, v in b.x.items()}
  ei = {et: np.asarray(v) for et, v in b.edge_index.items()}
  em = {et: np.asarray(v) for et, v in b.edge_mask.items()}
  return x, ei, em, int(np.asarray(b.num_sampled_nodes['paper'])[0])


def torch_inputs(x, ei, em):
  return ({t: torch.as_tensor(v) for t, v in x.items()},
          {et: torch.as_tensor(v) for et, v in ei.items()},
          {et: torch.as_tensor(v) for et, v in em.items()})


def close(a, b, what='', atol=ATOL, rtol=RTOL):
  np.testing.assert_allclose(np.asarray(a, np.float32),
                             np.asarray(b, np.float32), atol=atol,
                             rtol=rtol, err_msg=what)


def grads_match(tmodel, jgrads, what):
  """Every torch parameter's gradient equals flax's: a parameter flax
  never created has no gradient in torch either, and one whose output
  the loss never reads has None in torch and zeros in flax."""
  jg = convert.params_from_flax(jgrads, tmodel)
  for name, p in tmodel.named_parameters():
    if name not in jg:
      assert p.grad is None or not p.grad.abs().any(), name
      continue
    got = p.grad if p.grad is not None else torch.zeros_like(p)
    close(got.numpy(), jg[name].numpy(), f'{what} grad {name}',
          atol=1e-5, rtol=2e-4)
  assert any(p.grad is not None and p.grad.abs().any()
             for p in tmodel.parameters())


def test_gat_conv_matches_flax():
  """GATConv: a masked segment softmax per target, output and gradients,
  with padded edges, a target without messages and an all-masked edge
  block."""
  import jax
  from graphlearn_tpu.models.conv import GATConv as JGAT
  rng = np.random.default_rng(0)
  n, e = 20, 64
  x = rng.standard_normal((n, 6)).astype(np.float32)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 3, e)])
  ei[:, 50:] = -1
  em = ei[1] >= 0
  em[40:45] = False
  for heads, concat in ((2, True), (4, False)):
    jm = JGAT(5, heads=heads, concat=concat)
    params = jm.init(jax.random.PRNGKey(1), x, ei, em)
    tm = gtt.models.GATConv(6, 5, heads=heads, concat=concat)
    tm.load_state_dict(convert.params_from_flax(params, tm))
    w = rng.standard_normal((n, 5 * heads if concat else 5)).astype(
        np.float32)

    def jloss(p):
      return (jm.apply(p, x, ei, em) * w).sum()

    jout = np.asarray(jm.apply(params, x, ei, em))
    jgrad = jax.grad(jloss)(params)
    tout = tm(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em))
    close(tout.detach().numpy(), jout, f'gat heads={heads}')
    (tout * torch.as_tensor(w)).sum().backward()
    grads_match(tm, jax.tree_util.tree_map(np.asarray, jgrad), 'gat')


def _rgnn_pair(conv, x, ei, em, heads=2, **kw):
  """(flax RGNN, its params, port RGNN carrying them)."""
  import jax
  mk = dict(etypes=MSG_ETYPES, hidden_dim=8, out_dim=3, num_layers=2,
            out_ntype='paper', conv=conv, heads=heads)
  jm = glt.models.RGNN(**mk, **kw)
  params = jax.tree_util.tree_map(
      np.asarray, jm.init(jax.random.PRNGKey(0), x, ei, em))
  tm = gtt.models.RGNN(MSG_ETYPES, {t: v.shape[1] for t, v in x.items()},
                       8, 3, num_layers=2, conv=conv, heads=heads,
                       out_ntype='paper', device='cpu', **kw)
  sd = convert.params_from_flax(params, tm)
  missing = set(dict(tm.named_parameters())) - set(sd)
  assert all('.convs.' in m for m in missing), missing
  tm.load_state_dict(sd, strict=False)
  return jm, params, tm


def _check_forward_and_grads(jm, params, tm, x, ei, em, nseed, what):
  import jax
  rng = np.random.default_rng(3)
  jout = np.asarray(jm.apply(params, x, ei, em))
  w = rng.standard_normal(jout.shape).astype(np.float32)
  w[nseed:] = 0

  def jloss(p):
    return (jm.apply(p, x, ei, em) * w).sum()

  jgrad = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params))
  tx, tei, tem = torch_inputs(x, ei, em)
  tout = tm(tx, tei, tem)
  assert tout.shape == jout.shape
  close(tout.detach().numpy(), jout, what)
  (tout * torch.as_tensor(w)).sum().backward()
  grads_match(tm, jgrad, what)
  return tout.detach()


@pytest.mark.parametrize('conv', ['sage', 'gat'])
def test_rgnn_segment_and_hierarchical_match_flax(conv):
  """RGNN's segment forward (HeteroConv over per-edge-type SAGEConv /
  GATConv) and its hierarchical forward (hop offsets) on a typed tree
  batch: outputs and gradients equal flax's; the hierarchical seed
  logits equal the full forward's (tests/test_models.py:424)."""
  x, ei, em, nseed = jax_batch('tree')
  no, eo = glt.sampler.hetero_tree_layout({'paper': 8}, tuple(FAN), FAN)
  assert (no, eo) == gtt.sampler.hetero_tree_layout({'paper': 8},
                                                    tuple(FAN), FAN)
  jm, params, tm = _rgnn_pair(conv, x, ei, em)
  full = _check_forward_and_grads(jm, params, tm, x, ei, em, nseed,
                                  f'{conv} segment')
  jh, ph, th = _rgnn_pair(conv, x, ei, em, hop_node_offsets=no,
                          hop_edge_offsets=eo)
  hier = _check_forward_and_grads(jh, ph, th, x, ei, em, nseed,
                                  f'{conv} hierarchical')
  th.load_state_dict(tm.state_dict())
  hier = th(*torch_inputs(x, ei, em)).detach()
  close(hier[:nseed].numpy(), full[:nseed].numpy(), 'hier vs full',
        rtol=1e-5, atol=1e-6)


def _remap_to_dense(tseg, tdense):
  """The segment RGNN's per-edge-type conv weights in the dense layer's
  ``{lin_self,lin_nbr,lin,att_src,att_dst}_{stored ename}`` names."""
  sd = {}
  seg = dict(tseg.named_parameters())
  for name in dict(tdense.named_parameters()):
    head, _, leaf = name.partition('.')
    if not head.startswith('hetero'):
      sd[name] = seg[name]
      continue
    pname, _, wleaf = leaf.partition('.')
    for kind in ('lin_self', 'lin_nbr', 'att_src', 'att_dst', 'lin'):
      if pname.startswith(kind + '_'):
        stored = gtt.typing.to_edge_type(pname[len(kind) + 1:])
        msg = gtt.typing.as_str(gtt.typing.reverse_edge_type(stored))
        src = f'{head}.convs.{msg}.{kind}' + (f'.{wleaf}' if wleaf else '')
        sd[name] = seg[src]
        break
  return sd


@pytest.mark.parametrize('conv', ['sage', 'gat'])
@pytest.mark.parametrize('mode', ['tree', 'merge'])
def test_rgnn_dense_match_flax_and_segment(mode, conv):
  """RGNN tree_dense (typed tree batches) and merge_dense (calibrated
  merge batches) through TreeHeteroConv: outputs and gradients equal
  flax's, and the seed logits equal the port's own segment forward with
  the same weights (tests/test_models.py:623, :774)."""
  caps = None
  if mode == 'merge':
    caps = glt.sampler.estimate_hetero_frontier_caps(
        jax_dataset().graph, FAN, {'paper': 8}, num_probes=6, slack=1.5,
        multiple=4)
  x, ei, em, nseed = jax_batch('tree' if mode == 'tree' else 'merge', caps)
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN, etype_caps=caps)
  trecs, tno, teo = gtt.sampler.hetero_tree_blocks(
      {'paper': 8}, tuple(FAN), FAN, etype_caps=caps)
  assert (trecs, tno, teo) == (recs, no, eo)
  flag = {'tree_dense' if mode == 'tree' else 'merge_dense': True}
  jm, params, tm = _rgnn_pair(conv, x, ei, em, hop_node_offsets=no,
                              hop_edge_offsets=eo, tree_records=recs,
                              **flag)
  assert set(convert.params_from_flax(params, tm)) == \
      set(dict(tm.named_parameters()))
  dense = _check_forward_and_grads(jm, params, tm, x, ei, em, nseed,
                                   f'{conv} {mode}-dense')
  # the port's dense forward against its own segment forward
  tseg = gtt.models.RGNN(MSG_ETYPES, {t: v.shape[1] for t, v in x.items()},
                         8, 3, conv=conv, heads=2, out_ntype='paper',
                         device='cpu', hop_node_offsets=no,
                         hop_edge_offsets=eo,
                         generator=torch.Generator().manual_seed(5))
  tm.load_state_dict(_remap_to_dense(tseg, tm))
  with torch.no_grad():
    d = tm(*torch_inputs(x, ei, em))
    s = tseg(*torch_inputs(x, ei, em))
  close(d[:nseed].numpy(), s[:nseed].numpy(), 'dense vs segment',
        atol=2e-5, rtol=2e-4)
  del dense


@pytest.mark.parametrize('conv', ['sage', 'gat'])
def test_padded_seeds_give_finite_gradients(conv):
  """A batch of 5 seeds in an 8-slot cap: the pad slots' all-masked runs
  and empty segments must not put a NaN in any gradient (the softmax
  maxima are -inf there), in every forward."""
  x, ei, em, nseed = jax_batch('tree', seeds=np.array([0, 1, 2, 3, 4]))
  assert nseed == 5
  recs, no, eo = gtt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN)
  tx, tei, tem = torch_inputs(x, ei, em)
  y = torch.as_tensor(np.random.default_rng(0).integers(0, 3, 8))
  for kw in (dict(), dict(hop_node_offsets=no, hop_edge_offsets=eo),
             dict(hop_node_offsets=no, hop_edge_offsets=eo,
                  tree_dense=True, tree_records=recs)):
    tm = gtt.models.RGNN(MSG_ETYPES, {t: v.shape[1] for t, v in x.items()},
                         8, 3, conv=conv, heads=2, out_ntype='paper',
                         device='cpu',
                         generator=torch.Generator().manual_seed(0), **kw)
    loss_fn = gtt.models.train.make_loss_fn(tm, 3)
    loss, _ = loss_fn(dict(x=tx, edge_index=tei, edge_mask=tem, y=y,
                           num_seed_nodes=torch.tensor(nseed)))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in tm.named_parameters():
      if p.grad is not None:
        assert torch.isfinite(p.grad).all(), (kw, name)


def test_masked_run_softmax_matches_flax():
  """The dense GAT convs' run softmax: all-masked runs give 0, a very
  negative run keeps its true-max shift."""
  import jax.numpy as jnp
  from graphlearn_tpu.models.models import _masked_run_softmax as jsm
  from graphlearn_tpu_torch.models.models import _masked_run_softmax as tsm
  rng = np.random.default_rng(0)
  e = rng.standard_normal((9, 4, 3)).astype(np.float32)
  e[2] -= 200.0
  m = rng.random((9, 4)) < 0.6
  m[5] = False
  want = np.asarray(jsm(jnp.asarray(e), jnp.asarray(m), jnp.float32, 0.2))
  got = tsm(torch.as_tensor(e), torch.as_tensor(m), torch.float32, 0.2)
  close(got.numpy(), want, 'run softmax', atol=1e-6, rtol=1e-5)
  assert not got[5].any()


def test_rgnn_bf16_within_output_scale():
  """RGNN(dtype=bfloat16), tree-dense gat: float32 parameters, bfloat16
  logits within 3e-2 of the output's scale of flax's."""
  import jax
  import jax.numpy as jnp
  x, ei, em, nseed = jax_batch('tree')
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN)
  kw = dict(hop_node_offsets=no, hop_edge_offsets=eo, tree_dense=True,
            tree_records=recs)
  jm = glt.models.RGNN(etypes=MSG_ETYPES, hidden_dim=8, out_dim=3,
                       num_layers=2, out_ntype='paper', conv='gat',
                       heads=2, dtype=jnp.bfloat16, **kw)
  params = jax.tree_util.tree_map(
      np.asarray, jm.init(jax.random.PRNGKey(0), x, ei, em))
  tm = gtt.models.RGNN(MSG_ETYPES, {t: v.shape[1] for t, v in x.items()},
                       8, 3, conv='gat', heads=2, out_ntype='paper',
                       dtype=torch.bfloat16, device='cpu', **kw)
  tm.load_state_dict(convert.params_from_flax(params, tm))
  want = np.asarray(jm.apply(params, x, ei, em), np.float32)
  got = tm(*torch_inputs(x, ei, em))
  assert got.dtype == torch.bfloat16
  assert all(p.dtype == torch.float32 for p in tm.parameters())
  scale = np.abs(want).max()
  assert np.abs(got.detach().float().numpy() - want).max() <= 3e-2 * scale


def test_rgnn_params_round_trip_through_flax():
  """params_to_flax(params_from_flax(p)) is the flax tree again, for the
  segment (auto-named convs) and the dense (hetero{i}) layouts."""
  import jax
  x, ei, em, _ = jax_batch('tree')
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': 8}, tuple(FAN),
                                                FAN)
  for conv in ('sage', 'gat'):
    for kw in (dict(), dict(hop_node_offsets=no, hop_edge_offsets=eo,
                            tree_dense=True, tree_records=recs)):
      jm, params, tm = _rgnn_pair(conv, x, ei, em, **kw)
      back = convert.params_to_flax(
          convert.params_from_flax(params, tm), tm)
      flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
      flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
      assert len(flat_a) == len(flat_b)
      for path, arr in flat_a:
        np.testing.assert_array_equal(flat_b[path], arr)
