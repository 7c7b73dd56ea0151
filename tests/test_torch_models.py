"""The port's layered GraphSAGE against flax, weights carried across.

The forward runs on a real tree batch from the JAX loader, with 2 and 3
layers at hidden width 32 in float32. Logits agree within atol=1e-5,
rtol=1e-4 (the two frameworks sum in other orders); eval counts are
exact.
"""
import jax
import numpy as np
import pytest
import torch

import graphlearn_tpu as glt
import graphlearn_tpu_torch as gtt
from graphlearn_tpu.models import GraphSAGE as JaxSAGE
from graphlearn_tpu.models import train as jtrain
from graphlearn_tpu_torch.models import convert
from graphlearn_tpu_torch.models import train as ttrain


def _jax_batch(fanouts, batch, n=250, f=12, c=6):
  rng = np.random.default_rng(len(fanouts))
  ei = rng.integers(0, n, (2, 3000))
  ds = glt.data.Dataset()
  ds.init_graph(ei, num_nodes=n, graph_mode='CPU')
  ds.init_node_features(rng.standard_normal((n, f)).astype(np.float32))
  ds.init_node_labels(rng.integers(0, c, n).astype(np.int32))
  loader = glt.loader.NeighborLoader(ds, fanouts, np.arange(batch - 3),
                                     batch_size=batch, dedup='tree', seed=2)
  return jtrain.batch_to_dict(next(iter(loader))), f, c


def _torch_batch(jd):
  return {k: torch.as_tensor(np.array(v)) for k, v in jd.items()}


@pytest.mark.parametrize('fanouts', [[3, 2], [4, 3, 2]])
def test_tree_dense_forward_matches_flax(fanouts):
  batch = 8
  jd, f, c = _jax_batch(fanouts, batch)
  no, eo = jtrain.tree_hop_offsets(batch, fanouts)
  layers = len(fanouts)
  jmodel = JaxSAGE(hidden_dim=32, out_dim=c, num_layers=layers,
                   hop_node_offsets=no, hop_edge_offsets=eo,
                   tree_dense=True, fanouts=tuple(fanouts))
  params = jmodel.init(jax.random.PRNGKey(1), jd['x'], jd['edge_index'],
                       jd['edge_mask'])
  tmodel = gtt.models.GraphSAGE(f, 32, c, num_layers=layers,
                                hop_node_offsets=no, hop_edge_offsets=eo,
                                tree_dense=True, fanouts=fanouts,
                                device='cpu')
  tmodel.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  td = _torch_batch(jd)
  ref = np.asarray(jtrain.make_forward_fn(jmodel)(params, jd))
  with torch.no_grad():
    got = ttrain.make_forward_fn(tmodel)(td).numpy()
  assert got.shape == ref.shape == (no[1], c)
  np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
  jc, jt = jtrain.make_eval_counts(jmodel)(params, jd)
  tc, tt = ttrain.make_eval_counts(tmodel)(td)
  assert (int(jc), int(jt)) == (int(tc), int(tt))
  assert int(tt) == batch - 3


def test_params_from_flax_round_trip():
  no, eo = gtt.sampler.tree_layout(4, [3, 2])
  model = gtt.models.GraphSAGE(5, 7, 3, num_layers=2, hop_node_offsets=no,
                               hop_edge_offsets=eo, tree_dense=True,
                               fanouts=[3, 2],
                               device='cpu',
                               generator=torch.Generator().manual_seed(0))
  flax_tree = convert.params_to_flax(model.state_dict())
  assert flax_tree['params']['conv0']['lin_self']['kernel'].shape == (5, 7)
  assert set(flax_tree['params']['conv1']['lin_nbr']) == {'kernel'}
  back = convert.params_from_flax(flax_tree)
  assert back.keys() == model.state_dict().keys()
  for name, t in model.state_dict().items():
    torch.testing.assert_close(back[name], t, rtol=0, atol=0)


def test_seeded_init_is_reproducible():
  no, eo = gtt.sampler.tree_layout(4, [3, 2])

  def make():
    return gtt.models.GraphSAGE(5, 7, 3, num_layers=2, hop_node_offsets=no,
                                hop_edge_offsets=eo, tree_dense=True,
                                fanouts=[3, 2],
                                device='cpu',
                                generator=torch.Generator().manual_seed(9))

  a, b = make(), make()
  for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
    torch.testing.assert_close(p, q, rtol=0, atol=0)
    bound = 1.0 / (5 if name.startswith('conv0') else 7) ** 0.5
    assert float(p.abs().max()) <= bound
