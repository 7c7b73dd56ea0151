"""The ported remote-stack examples against the JAX package on the CPU:
``examples/distributed/server_client/sage_server.py`` + ``sage_client.py``
(one module with two subcommands here) and
``examples/hetero/train_hgt_mag_mp.py``, each at a small size.

The JAX examples spawn JAX processes (a server, mp workers), so their
batches are rebuilt in this process the way JAX's worker builds them:
JAX's in-process ``NeighborSampler`` at the worker's seed and call
index, the worker's feature and label gathers, and JAX's
``output_to_message`` -> ``message_to_data``. The port's first trained
batch equals that batch, and the port's first loss, from the JAX
model's parameters (through the weight converter), equals the JAX
model's loss on it within rtol 1e-4 / atol 1e-5.
"""
import argparse
import threading
import time

import numpy as np
import torch

import graphlearn_tpu as glt
from graphlearn_tpu.distributed import message as jmsg
from graphlearn_tpu_torch.channel import live_channel_count

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def test_sage_server_client_example_matches_jax():
  import jax

  from graphlearn_tpu.models import train as jtrain
  from graphlearn_tpu_torch.examples import sage_server_client as ex
  n, deg, bs = 600, 4, 128
  base = live_channel_count()
  ei, feat, labels = ex.make_data(n, deg)
  # the JAX server's draws, in its order
  rng = np.random.default_rng(0)
  np.testing.assert_array_equal(ei[0], rng.integers(0, n, n * deg))
  np.testing.assert_array_equal(ei[1], rng.integers(0, n, n * deg))
  np.testing.assert_array_equal(
      feat, rng.standard_normal((n, 64)).astype(np.float32))
  np.testing.assert_array_equal(labels, rng.integers(0, 16, n))
  # JAX's first trained batch: the client left a first epoch after one
  # batch, which the server's one worker (seed 0 * 7919 * 1000003 + 0)
  # finished; the trained epoch starts at call ceil(n / bs) + 1
  jds = glt.data.Dataset()
  jds.init_graph(ei, graph_mode='CPU', num_nodes=n)
  js = glt.sampler.NeighborSampler(jds.graph, ex.FANOUTS, seed=0)
  js._call_count = -(-n // bs)
  out = js.sample_from_nodes(glt.sampler.NodeSamplerInput(np.arange(bs)),
                             batch_cap=bs)
  node = np.asarray(out.node)
  jb = jmsg.message_to_data(jmsg.output_to_message(
      out, feat[np.maximum(node, 0)], labels[np.clip(node, 0, n - 1)]))
  model = glt.models.GraphSAGE(hidden_dim=128, out_dim=16, num_layers=2)
  jbatch = jtrain.batch_to_dict(jb)
  state, tx = jtrain.create_train_state(model, jax.random.PRNGKey(0),
                                        jbatch)
  train_step, _ = jtrain.make_train_step(model, tx, 16)
  _, jloss, _ = train_step(state, jbatch)
  params = jax.tree.map(np.asarray, state.params)

  ready = []
  sargs = argparse.Namespace(num_nodes=n, avg_deg=deg, device='cpu',
                             num_clients=1, port=0)
  server = threading.Thread(target=ex.run_server, args=(sargs, ready.append),
                            daemon=True)
  server.start()
  deadline = time.monotonic() + 60
  while not ready and time.monotonic() < deadline:
    time.sleep(0.02)
  host, port = ready[0]
  cargs = argparse.Namespace(host=host, port=port, num_nodes=n, epochs=1,
                             batch_size=bs, seed=0, device='cpu')
  result, losses, first = ex.run_client(cargs, params=params)
  server.join(30)
  assert not server.is_alive()        # the client's exit stopped it
  assert live_channel_count() == base
  assert result['batches'] == len(losses) == -(-n // bs)
  np.testing.assert_array_equal(first.node.numpy(), node)
  np.testing.assert_array_equal(first.edge_index.numpy(),
                                np.asarray(jb.edge_index))
  np.testing.assert_array_equal(first.edge_mask.numpy(),
                                np.asarray(jb.edge_mask))
  np.testing.assert_array_equal(first.x.numpy(), np.asarray(jb.x))
  np.testing.assert_array_equal(first.y.numpy(), np.asarray(jb.y))
  np.testing.assert_allclose(losses[0], float(jloss), **TOL)


def test_train_hgt_mag_mp_example_matches_jax():
  import jax
  import jax.numpy as jnp
  import optax

  from graphlearn_tpu.models import HGT
  from graphlearn_tpu_torch.examples import train_hgt_mag as base_ex
  from graphlearn_tpu_torch.examples import train_hgt_mag_mp as ex
  from graphlearn_tpu_torch.typing import reverse_edge_type as rev
  args = argparse.Namespace(epochs=1, n_paper=600, batch_size=32,
                            hidden=16, heads=2, lr=3e-3, num_workers=1,
                            channel_size=1 << 24, seed=0, device='cpu')
  n_paper, bs, ncls = args.n_paper, args.batch_size, base_ex.NUM_CLASSES
  rng = np.random.default_rng(0)
  n_author, n_inst, n_field = n_paper // 2, 200, 500
  cites, writes, affil, topic, feats, label = base_ex.make_mag_like(
      n_paper, n_author, n_inst, n_field, ncls, rng)
  arrays = (cites, writes, affil, topic, writes[::-1].copy(),
            affil[::-1].copy(), topic[::-1].copy())
  edges = dict(zip(base_ex.EDGE_TYPES, arrays))
  nnodes = dict(zip(base_ex.NODE_TYPES, (n_paper, n_author, n_inst,
                                         n_field)))
  jds = glt.data.Dataset(edge_dir='out')
  jds.init_graph(edges, graph_mode='CPU',
                 num_nodes={et: nnodes[et[0]] for et in edges})
  fan = base_ex.FANOUTS
  # the one worker (seed 0 * 1000003 + 0), its first shuffled block
  n_tr = int(n_paper * 0.2)
  block = np.arange(n_tr)[np.random.default_rng(0).permutation(n_tr)][:bs]
  js = glt.sampler.NeighborSampler(jds.graph, fan, seed=0)
  out = js.sample_from_nodes(glt.sampler.NodeSamplerInput(block, 'paper'),
                             batch_cap=bs)
  x_d = {t: feats[t][np.maximum(np.asarray(v), 0)]
         for t, v in out.node.items()}
  y_d = {'paper': label[np.clip(np.asarray(out.node['paper']), 0,
                                n_paper - 1)]}
  jb = jmsg.message_to_data(jmsg.hetero_output_to_message(out, x_d, y_d))
  # the JAX example's model and loss
  recs, no, eo = glt.sampler.hetero_tree_blocks({'paper': bs}, tuple(edges),
                                                fan)
  model = HGT(ntypes=tuple(nnodes), etypes=tuple(rev(et) for et in edges),
              hidden_dim=args.hidden, out_dim=ncls, heads=args.heads,
              num_layers=2, out_ntype='paper', hop_node_offsets=no,
              hop_edge_offsets=eo, tree_records=recs, merge_dense=True)
  b = dict(x=jb.x, ei=jb.edge_index, em=jb.edge_mask, y=jb.y['paper'],
           num_seed=jnp.asarray(jb.num_sampled_nodes['paper'])[0])
  params = model.init(jax.random.PRNGKey(0), b['x'], b['ei'], b['em'])
  logits = model.apply(params, b['x'], b['ei'], b['em'])
  n = logits.shape[0]
  seed_mask = jnp.arange(n) < b['num_seed']
  ce = optax.softmax_cross_entropy(logits, jax.nn.one_hot(b['y'][:n], ncls))
  jloss = float(jnp.where(seed_mask, ce, 0.0).sum() /
                jnp.maximum(seed_mask.sum(), 1))

  base = live_channel_count()
  result, losses, first = ex.run(args, params=jax.tree.map(np.asarray,
                                                           params))
  assert live_channel_count() == base
  assert result['epochs'] == 1 and len(losses) == n_tr // bs
  for t, v in out.node.items():
    np.testing.assert_array_equal(first.node[t].numpy(), np.asarray(v))
    np.testing.assert_array_equal(first.x[t].numpy(), x_d[t])
  for et, ei in jb.edge_index.items():
    np.testing.assert_array_equal(first.edge_index[et].numpy(),
                                  np.asarray(ei))
  np.testing.assert_array_equal(first.y['paper'].numpy(), y_d['paper'])
  np.testing.assert_allclose(losses[0], jloss, **TOL)
