"""Unsupervised bipartite GraphSAGE on a Taobao-shaped user-item graph, on
the port.

Counterpart of ``examples/hetero/bipartite_sage_unsup.py``: the Taobao
dataset is not in the repository, so the JAX example's interest-group
synthetic is built here from the same numpy stream
(``make_taobao_like``: 20,000 users of 8 interest groups clicking 12
items each, 85% of the clicks inside the user's group, over 5,000 items);
an 80/20 split of the user->item edges, and an item<->item relation of
pairs co-clicked by at least 3 users of the training split
(``item_cooccurrence``). The typed ``LinkNeighborLoader`` draws ``{u2i:
[8, 4], i2u: [8, 4], i2i: [4, 2]}`` around batches of 512 training edges
with one binary negative each (typed link sampling), and a two-tower
encoder (``TwoTower``: ``nn.Embedding`` towers for users and items by
node id, then two ``HeteroConv`` layers of ``SAGEConv`` with ReLU
between) scores each pair by the dot product of its ends; masked
sigmoid cross-entropy, Adam at 1e-3. The test split's rank-statistic AUC
closes the run; the last line is the JAX example's JSON line.

Run on the card:   python -m graphlearn_tpu_torch.examples.bipartite_sage_unsup
On the CPU:        ... --device cpu --n-user 2000 --n-item 500
"""
import argparse
import json
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import HeteroConv, SAGEConv
from ..models.models import draw_parameters
from ..typing import as_str, reverse_edge_type
from ..utils import resolve_device

U2I = ('user', 'to', 'item')
I2U = ('item', 'rev_to', 'user')
I2I = ('item', 'to', 'item')
EDGE_TYPES = (U2I, I2U, I2I)
FANOUTS = {U2I: [8, 4], I2U: [8, 4], I2I: [4, 2]}
# the message-direction edge types a batch carries (edge_dir='out')
MODEL_ETYPES = tuple(reverse_edge_type(et) for et in EDGE_TYPES)


def make_taobao_like(n_user, n_item, n_groups, clicks_per_user, rng):
  """The JAX example's click synthetic, draw for draw: ``[2, E]`` user ->
  item edges, ``clicks_per_user`` a user, 85% inside its interest
  group's items (groups dealt to items round-robin)."""
  ug = rng.integers(0, n_groups, n_user).astype(np.int32)
  ig = (np.arange(n_item) % n_groups).astype(np.int32)
  order = np.argsort(ig, kind='stable').astype(np.int32)
  counts = np.bincount(ig, minlength=n_groups)
  offsets = np.zeros(n_groups + 1, np.int64)
  np.cumsum(counts, out=offsets[1:])
  u = np.repeat(np.arange(n_user, dtype=np.int32), clicks_per_user)
  e = u.shape[0]
  intra = rng.random(e) < 0.85
  it = rng.integers(0, n_item, e).astype(np.int32)
  gsel = ug[u[intra]]
  pick = (rng.random(intra.sum()) * counts[gsel]).astype(np.int64)
  it[intra] = order[offsets[gsel] + pick]
  return np.stack([u, it])


def item_cooccurrence(u2i, min_count, cap=200_000):
  """item<->item pairs co-clicked by at least ``min_count`` users, both
  directions, in the JAX example's order (at most ``cap`` pairs)."""
  by_user = {}
  for u, i in zip(u2i[0], u2i[1]):
    by_user.setdefault(int(u), []).append(int(i))
  pairs = Counter()
  for items in by_user.values():
    items = sorted(set(items))
    for a_i in range(len(items)):
      for b_i in range(a_i + 1, len(items)):
        pairs[(items[a_i], items[b_i])] += 1
  keep = [(a, b) for (a, b), c in pairs.items() if c >= min_count][:cap]
  if not keep:
    return np.zeros((2, 0), np.int32)
  arr = np.array(keep, np.int32).T
  return np.concatenate([arr, arr[::-1]], axis=1)


def make_data(n_user, n_item):
  """``(edges, num_nodes, train_e, test_e, i2i)``: the synthetic, its
  80/20 edge split and the typed graph's three edge types, from
  ``default_rng(0)`` as in the JAX example."""
  rng = np.random.default_rng(0)
  u2i = make_taobao_like(n_user, n_item, 8, 12, rng)
  e = u2i.shape[1]
  perm = rng.permutation(e)
  n_tr = int(e * 0.8)
  train_e, test_e = u2i[:, perm[:n_tr]], u2i[:, perm[n_tr:]]
  i2i = item_cooccurrence(train_e, min_count=3)
  edges = {U2I: train_e, I2U: train_e[::-1].copy(), I2I: i2i}
  num_nodes = {U2I: n_user, I2U: n_item, I2I: n_item}
  return edges, num_nodes, train_e, test_e, i2i


class TwoTower(nn.Module):
  """The JAX example's encoder: ``emb_user`` / ``emb_item`` id embeddings,
  then two ``HeteroConv`` layers (``hetero0``, ``hetero1``) of
  ``SAGEConv`` per message-direction edge type, ReLU between.
  ``forward(node_dict, edge_index_dict, edge_mask_dict)`` takes the
  batch's node ids per type and returns the per-type outputs."""

  num_layers = 2

  def __init__(self, n_user: int, n_item: int, hidden: int):
    super().__init__()
    self.emb_user = nn.Embedding(n_user, hidden)
    self.emb_item = nn.Embedding(n_item, hidden)
    for i in range(self.num_layers):
      self.add_module(f'hetero{i}', HeteroConv(
          {et: SAGEConv(hidden, hidden) for et in MODEL_ETYPES}))

  def flax_scope(self, mods):
    """flax's names (``models.convert``): the convs the JAX example builds
    in its own scope are its auto-named ``SAGEConv_{i*E + j}`` at the top
    level."""
    if len(mods) >= 3 and mods[0].startswith('hetero') and \
        mods[1] == 'convs':
      i = int(mods[0][len('hetero'):])
      j = [as_str(et) for et in MODEL_ETYPES].index(mods[2])
      return [f'SAGEConv_{i * len(MODEL_ETYPES) + j}'] + list(mods[3:])
    return list(mods)

  def forward(self, node_dict, edge_index_dict, edge_mask_dict):
    x = {'user': self.emb_user(node_dict['user'].clamp(min=0).long()),
         'item': self.emb_item(node_dict['item'].clamp(min=0).long())}
    for i in range(self.num_layers):
      x = getattr(self, f'hetero{i}')(x, edge_index_dict, edge_mask_dict)
      if i == 0:
        x = {t: torch.relu(v) for t, v in x.items()}
    return x


def build_model(n_user, n_item, hidden, device=None, generator=None):
  """``TwoTower`` on ``device`` (None: the card), its weights drawn from
  ``generator`` (``models.models.draw_parameters``)."""
  model = TwoTower(n_user, n_item, hidden)
  with torch.no_grad():
    draw_parameters(model, generator)
  return model.to(resolve_device(device))


def batch_dict(batch):
  """A typed link batch -> the step's dict: node ids per type (the
  towers' input), edges, masks and the supervision pairs."""
  return dict(x=batch.node, edge_index=batch.edge_index,
              edge_mask=batch.edge_mask,
              edge_label_index=batch.metadata['edge_label_index'],
              edge_label=batch.metadata['edge_label'])


def scores(model, batch):
  """``(score, valid)`` of the batch's pairs: the dot product of the user
  and item outputs (float32); a pair with a -1 end is not valid."""
  h = model(batch['x'], batch['edge_index'], batch['edge_mask'])
  hu, hi = h['user'].float(), h['item'].float()
  eli = batch['edge_label_index']
  valid = (eli[0] >= 0) & (eli[1] >= 0)
  s = (hu.index_select(0, eli[0].clamp(min=0).long()) *
       hi.index_select(0, eli[1].clamp(min=0).long())).sum(-1)
  return s, valid


def make_step(model):
  """``(train_step, eval_step)`` of ``models.train``'s contract over the
  JAX example's loss: optax's sigmoid binary cross-entropy of the scores
  against ``edge_label``, averaged over the valid pairs (its second
  value the share of pairs whose score's sign matches the label)."""
  from ..models import train as train_lib

  def loss_fn(batch):
    s, valid = scores(model, batch)
    lab = batch['edge_label'].float()
    bce = -lab * F.logsigmoid(s) - (1.0 - lab) * F.logsigmoid(-s)
    pairs = torch.clamp(valid.sum(), min=1).float()
    hit = ((s > 0) == (lab > 0.5)) & valid
    return torch.where(valid, bce, 0.0).sum() / pairs, hit.sum() / pairs

  return train_lib._steps(loss_fn)


def rank_auc(s, lab) -> float:
  """P(score_pos > score_neg) by the rank statistic, as the JAX
  example computes it."""
  order = np.argsort(s, kind='stable')
  ranks = np.empty_like(order, np.float64)
  ranks[order] = np.arange(1, len(s) + 1)
  n_pos = int((lab > 0.5).sum())
  n_neg = len(lab) - n_pos
  return float((ranks[lab > 0.5].sum() - n_pos * (n_pos + 1) / 2) /
               max(n_pos * n_neg, 1))


def loaders(ds, train_e, test_e, batch_size, device):
  """The JAX example's two typed link loaders (binary 1:1 negatives, no
  features: the towers read node ids)."""
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.sampler import NegativeSampling
  kw = dict(neg_sampling=NegativeSampling('binary', 1),
            batch_size=batch_size, drop_last=True, collect_features=False,
            device=device)
  return (gtt.loader.LinkNeighborLoader(ds, FANOUTS, (U2I, train_e),
                                        shuffle=True, seed=0, **kw),
          gtt.loader.LinkNeighborLoader(ds, FANOUTS, (U2I, test_e),
                                        shuffle=False, seed=1, **kw))


def run(args, params=None):
  """Train and test as the JAX example does; returns ``(result, losses)``
  with the per-step losses as floats. ``params``: flax parameters of the
  JAX example's model to start from (numpy leaves; default: torch's
  initialisation from ``--seed``)."""
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  device = resolve_device(args.device)
  cuda = device.type == 'cuda'
  edges, num_nodes, train_e, test_e, i2i = make_data(args.n_user,
                                                     args.n_item)
  ds = gtt.data.Dataset(edge_dir='out', device=device)
  ds.init_graph(edges, num_nodes=num_nodes)
  loader, test_loader = loaders(ds, train_e, test_e, args.batch_size,
                                device)
  model = build_model(args.n_user, args.n_item, args.hidden, device,
                      generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model))
  # the JAX example initialises its model from one batch of ``loader``:
  # drawing it here keeps the two examples' streams in step
  next(iter(loader))
  state = train_lib.create_train_state(model, lr=args.lr)
  train_step, _ = make_step(model)
  sync = torch.cuda.synchronize if cuda else (lambda: None)

  losses, epoch_times = [], []
  for _ in range(args.epochs):
    t0 = time.perf_counter()
    for batch in loader:
      state, loss, _ = train_step(state, batch_dict(batch))
      losses.append(loss)
    sync()
    epoch_times.append(time.perf_counter() - t0)
  all_s, all_l = [], []
  with torch.no_grad():
    for batch in test_loader:
      b = batch_dict(batch)
      s, valid = scores(model, b)
      all_s.append(s[valid])
      all_l.append(b['edge_label'][valid])
  s = torch.cat(all_s).cpu().numpy()        # the host reads: after the test
  lab = torch.cat(all_l).cpu().numpy()
  losses = [float(v) for v in losses]
  result = {
      'model': 'bipartite-SAGE-unsup',
      'n_user': args.n_user, 'n_item': args.n_item,
      'i2i_edges': int(i2i.shape[1]),
      'epochs': args.epochs,
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'test_auc': round(rank_auc(s, lab), 4),
      'epoch_time_s_wall': round(float(np.mean(epoch_times)), 3),
  }
  return result, losses


def parser():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--n-user', type=int, default=20_000)
  ap.add_argument('--n-item', type=int, default=5_000)
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--lr', type=float, default=1e-3)
  ap.add_argument('--seed', type=int, default=0,
                  help='seed of the initial weights')
  ap.add_argument('--device', default=None,
                  help="torch device (default: the card; 'cpu' to run on "
                       'the CPU)')
  return ap


def main(argv=None):
  result, _ = run(parser().parse_args(argv))
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
