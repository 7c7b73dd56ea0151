"""The ported bipartite (two-tower) link prediction example against
``examples/hetero/bipartite_sage_unsup.py``, on the CPU, at 2,000 users
and 500 items.

The JAX example runs as it is and each call of its jitted ``step`` is
recorded (``test_torch_model_examples.record_jax_steps``). The port's
example then runs the same epoch, each step taken up from JAX's
parameters and Adam state of that step (``models.convert``: ``emb_*``
tables, the top-level ``SAGEConv_k`` of each ``hetero{i}`` conv): the
typed link batch is held exact (node ids, edges, masks, label pairs,
labels), the loss within rtol 1e-4, the gradients within atol 1e-5 /
rtol 2e-4 and Adam on JAX's gradients to JAX's parameters after the
step. The synthetic, the split and the item co-occurrence relation equal
the JAX example's array for array.
"""
import numpy as np
import pytest
import torch

from test_torch_model_examples import (
    _eq, check_readings, held_step, load_jax_example, record_jax_steps)

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

ARGV = ['--epochs', '1', '--n-user', '2000', '--n-item', '500',
        '--hidden', '16']


def _jax_module():
  return load_jax_example('examples/hetero/bipartite_sage_unsup.py',
                          'jax_bipartite_sage_unsup')


def test_bipartite_synthetic_matches_jax():
  """``make_taobao_like``, the 80/20 split and ``item_cooccurrence`` give
  the JAX example's arrays."""
  from graphlearn_tpu_torch.examples import bipartite_sage_unsup as example
  mod = _jax_module()
  rng = np.random.default_rng(0)
  u2i = mod.make_taobao_like(2000, 500, 8, 12, rng)
  perm = rng.permutation(u2i.shape[1])
  n_tr = int(u2i.shape[1] * 0.8)
  train_e = u2i[:, perm[:n_tr]]
  edges, num_nodes, tr, te, i2i = example.make_data(2000, 500)
  np.testing.assert_array_equal(tr, train_e)
  np.testing.assert_array_equal(te, u2i[:, perm[n_tr:]])
  np.testing.assert_array_equal(i2i, mod.item_cooccurrence(train_e, 3))
  assert list(edges) == [mod.U2I, mod.I2U, mod.I2I]
  assert num_nodes == {mod.U2I: 2000, mod.I2U: 500, mod.I2I: 500}
  assert example.MODEL_ETYPES == tuple(
      example.reverse_edge_type(et) for et in edges)


def test_bipartite_example_steps_agree_from_the_jax_state(monkeypatch):
  """Every step of one epoch (37 steps of 512 edges and 512 negatives),
  held from JAX's state: the typed link batch exact, loss, gradients
  and update within the stated tolerances; the JSON line's keys are the
  JAX example's."""
  from graphlearn_tpu_torch.examples import bipartite_sage_unsup as example
  steps = record_jax_steps(monkeypatch, _jax_module(), ARGV, aux=False)
  readings = []

  def make_held(model):
    import torch.nn.functional as F

    def step(state, batch):
      rec = steps[len(readings)]

      def loss_of():
        s, valid = example.scores(model, batch)
        lab = batch['edge_label'].float()
        bce = -lab * F.logsigmoid(s) - (1.0 - lab) * F.logsigmoid(-s)
        return torch.where(valid, bce, 0.0).sum() / torch.clamp(
            valid.sum(), min=1).float()

      def batch_equal(jb):
        return all(_eq({k: v.numpy() for k, v in batch[t].items()}, jb[j])
                   for t, j in (('x', 'x'), ('edge_index', 'ei'),
                                ('edge_mask', 'em'))) and \
            _eq(batch['edge_label_index'].numpy(), jb['eli']) and \
            _eq(batch['edge_label'].numpy(), jb['lab'])

      readings.append(held_step(model, state.optimizer, rec, loss_of,
                                batch_equal))
      return state._replace(step=state.step + 1), torch.zeros(()), \
          torch.zeros(())

    return step, None

  monkeypatch.setattr(example, 'make_step', make_held)
  args = example.parser().parse_args(ARGV + ['--device', 'cpu'])
  result, _ = example.run(args, steps[0]['params'])
  check_readings(readings, len(steps))
  assert len(steps) == 37
  assert set(result) == {'model', 'n_user', 'n_item', 'i2i_edges', 'epochs',
                         'first_loss', 'final_loss', 'test_auc',
                         'epoch_time_s_wall'}
  assert 0.0 <= result['test_auc'] <= 1.0


def test_bipartite_model_round_trips_flax_names():
  """``convert`` carries the JAX example's parameter tree onto the
  two-tower model and back leaf for leaf (``emb_user`` / ``emb_item``
  tables, ``SAGEConv_0`` .. ``SAGEConv_5``)."""
  from graphlearn_tpu_torch.examples import bipartite_sage_unsup as example
  from graphlearn_tpu_torch.models import convert
  model = example.build_model(30, 20, 4, 'cpu',
                              torch.Generator().manual_seed(0))
  tree = convert.params_to_flax(model.state_dict(), model)['params']
  assert sorted(tree) == ['SAGEConv_0', 'SAGEConv_1', 'SAGEConv_2',
                          'SAGEConv_3', 'SAGEConv_4', 'SAGEConv_5',
                          'emb_item', 'emb_user']
  assert tree['emb_user']['embedding'].shape == (30, 4)
  back = convert.params_from_flax({'params': tree}, model)
  assert set(back) == set(model.state_dict())
  for k, v in model.state_dict().items():
    assert torch.equal(back[k], v), k
