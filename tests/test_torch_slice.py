"""The whole slice against the JAX package, batch for batch.

Dataset -> NeighborLoader(dedup='tree') -> collate -> layered GraphSAGE
forward -> eval counts, for shuffle=False and shuffle=True (the seed
permutation comes from numpy in both packages; the shuffled run also
gathers seed labels only), with the flax weights
carried across. Ids, masks, features and labels are exact; logits agree
within atol=1e-5, rtol=1e-4 (the two frameworks sum in other orders).
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

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

N, F, C = 300, 16, 5
FANOUTS = [4, 3]
BATCH = 16


def _data(seed=0):
  rng = np.random.default_rng(seed)
  e = 2400
  rows = rng.integers(0, N, e)
  cols = np.empty(e, np.int64)
  cols[:e // 2] = rng.integers(0, N, e // 2)
  cols[e // 2:] = rng.zipf(1.5, e - e // 2) % N
  feats = rng.standard_normal((N, F)).astype(np.float32)
  labels = rng.integers(0, C, N).astype(np.int32)
  seeds = rng.permutation(N)[:56]     # 3 full batches + a ragged tail
  return np.stack([rows, cols]), feats, labels, seeds


@pytest.mark.parametrize('shuffle,seed_labels_only', [(False, False),
                                                      (True, True)])
def test_slice_matches_jax(shuffle, seed_labels_only):
  ei, feats, labels, seeds = _data()
  jds = glt.data.Dataset()
  jds.init_graph(ei, num_nodes=N, graph_mode='CPU')
  jds.init_node_features(feats)
  jds.init_node_labels(labels)
  tds = gtt.data.Dataset(device='cpu')
  tds.init_graph(ei, num_nodes=N)
  tds.init_node_features(feats)
  tds.init_node_labels(labels)
  jl = glt.loader.NeighborLoader(jds, FANOUTS, seeds, batch_size=BATCH,
                                 shuffle=shuffle, seed=3, dedup='tree',
                                 seed_labels_only=seed_labels_only)
  tl = gtt.loader.NeighborLoader(tds, FANOUTS, seeds, batch_size=BATCH,
                                 shuffle=shuffle, seed=3, dedup='tree',
                                 device='cpu',
                                 seed_labels_only=seed_labels_only)
  no, eo = jtrain.tree_hop_offsets(BATCH, FANOUTS)
  assert (no, eo) == ttrain.tree_hop_offsets(BATCH, FANOUTS)
  jmodel = JaxSAGE(hidden_dim=32, out_dim=C, num_layers=2,
                   hop_node_offsets=no, hop_edge_offsets=eo,
                   tree_dense=True, fanouts=tuple(FANOUTS))
  tmodel = gtt.models.GraphSAGE(F, 32, C, num_layers=2, hop_node_offsets=no,
                                hop_edge_offsets=eo, tree_dense=True,
                                fanouts=FANOUTS, device='cpu')
  jcounts = jtrain.make_eval_counts(jmodel)
  tcounts = ttrain.make_eval_counts(tmodel)
  params = None
  n_batches = 0
  for jb, tb in zip(jl, tl):
    jd, td = jtrain.batch_to_dict(jb), ttrain.batch_to_dict(tb)
    for key in ('x', 'edge_index', 'edge_mask', 'y'):
      np.testing.assert_array_equal(np.asarray(jd[key]), td[key].numpy(),
                                    err_msg=key)
    assert int(jd['num_seed_nodes']) == int(td['num_seed_nodes'])
    assert td['y'].shape[0] == (BATCH if seed_labels_only else no[-1])
    if params is None:
      params = jmodel.init(jax.random.PRNGKey(0), jd['x'],
                           jd['edge_index'], jd['edge_mask'])
      tmodel.load_state_dict(convert.params_from_flax(
          jax.tree.map(np.asarray, params)))
    ref = np.asarray(jmodel.apply(params, jd['x'], jd['edge_index'],
                                  jd['edge_mask']))
    with torch.no_grad():
      got = ttrain.make_forward_fn(tmodel)(td).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    jc, jt = jcounts(params, jd)
    tc, tt = tcounts(td)
    assert (int(jc), int(jt)) == (int(tc), int(tt))
    n_batches += 1
  assert n_batches == len(tl) == len(jl) == 4
