"""SEAL link prediction on the port: enclosing subgraphs, DRNL and a
DGCNN.

Counterpart of ``examples/seal_link_pred.py``: for every candidate link
the k-hop enclosing subgraph around ``(src, dst)`` comes from the port's
``NeighborSampler.subgraph`` (capped fanouts, ``--fanout 8 8``), the
target link is removed, Double-Radius Node Labeling (DRNL, scipy's
shortest paths) labels the nodes, and the subgraph is padded to fixed
node and edge caps. A DGCNN (a GCN stack over DRNL label embeddings,
global sort pooling of the top ``k`` nodes, a per-row conv, ``Conv1d(5)``
with flax's 'SAME' padding and an MLP) classifies the links, trained with
sigmoid cross-entropy and Adam at 1e-3 and reported as test AUC.

The batch is ``[B, N]`` padded graphs: the DGCNN runs its GCN stack on
the ``B * N`` nodes of the batch at once (each graph's edges shifted into
its own row block, so degrees stay per graph), which is what the JAX
example's ``nn.vmap`` over graphs computes. Cora is not in the repository,
so the JAX example's Cora-scale community graph stands in, from the same
numpy stream, and so do its link splits and negatives.

Run on the card:   python -m graphlearn_tpu_torch.examples.seal_link_pred
On the CPU:        ... --device cpu
"""
import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Z_CAP = 64


def drnl_node_labeling(rows, cols, num_nodes, src, dst):
  """DRNL z-labels: the distances to ``src`` computed without ``dst``
  (and the reverse) combined into one structural label; ``src`` and
  ``dst`` get 1, unreachable nodes 0."""
  import scipy.sparse as sp
  from scipy.sparse.csgraph import shortest_path
  adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(num_nodes, num_nodes)).tocsr()
  src, dst = (dst, src) if src > dst else (src, dst)
  idx_wo_src = list(range(src)) + list(range(src + 1, num_nodes))
  idx_wo_dst = list(range(dst)) + list(range(dst + 1, num_nodes))
  adj_wo_src = adj[idx_wo_src, :][:, idx_wo_src]
  adj_wo_dst = adj[idx_wo_dst, :][:, idx_wo_dst]
  d2src = shortest_path(adj_wo_dst, directed=False, unweighted=True,
                        indices=src)
  d2src = np.insert(d2src, dst, 0, axis=0)
  d2dst = shortest_path(adj_wo_src, directed=False, unweighted=True,
                        indices=dst - 1)
  d2dst = np.insert(d2dst, src, 0, axis=0)
  dist = d2src + d2dst
  with np.errstate(invalid='ignore'):   # inf distances -> nan -> z = 0
    dist_over_2, dist_mod_2 = dist // 2, dist % 2
    z = 1 + np.minimum(d2src, d2dst)
    z += dist_over_2 * (dist_over_2 + dist_mod_2 - 1)
  z[src] = 1.0
  z[dst] = 1.0
  z[np.isnan(z)] = 0.0
  return z.astype(np.int64)


class DGCNN(nn.Module):
  """The DGCNN over a ``[B, N]`` batch of padded graphs: DRNL label
  embedding (``z_embed``), ``num_layers`` GCNConvs of width ``hidden``
  and one of width 1 (``gcn{i}``, ``gcn_last``), tanh after each, their
  outputs concatenated; sort pooling of the ``k`` valid nodes with the
  largest last channel (a stable sort, as ``jnp.argsort``; padding nodes
  last and zeroed); ``conv1`` on each row (the reference's stride-width
  Conv1d), ReLU, max pool 2; ``conv2`` (Conv1d of kernel 5, 'SAME'),
  ReLU; ``mlp1`` (ReLU), ``mlp2``: one logit per graph. The parameter
  names are the flax module's (``models.convert`` maps a flax ``Conv``
  kernel ``[k, in, out]`` onto ``conv2``'s weight and ``Embed``'s table
  onto ``z_embed``). ``device=None`` means the card; weights are drawn
  on the CPU from ``generator``."""

  def __init__(self, hidden: int = 32, num_layers: int = 3, k: int = 30,
               device=None, generator=None):
    super().__init__()
    from graphlearn_tpu_torch.models.conv import GCNConv
    from graphlearn_tpu_torch.models.models import draw_parameters
    from graphlearn_tpu_torch.utils import resolve_device
    device = resolve_device(device)
    self.k, self.num_layers = k, num_layers
    self.z_embed = nn.Embedding(Z_CAP, hidden)
    for i in range(num_layers):
      self.add_module(f'gcn{i}', GCNConv(hidden, hidden))
    self.gcn_last = GCNConv(hidden, 1)
    total = hidden * num_layers + 1
    self.conv1 = nn.Linear(total, 16)
    self.pool = nn.MaxPool1d(2, 2)
    self.conv2 = nn.Conv1d(16, 32, 5, padding=2)
    self.mlp1 = nn.Linear((k // 2) * 32, 128)
    self.mlp2 = nn.Linear(128, 1)
    draw_parameters(self, generator)
    self.to(device)

  def sort_order(self, h, nmask):
    """``[B, k]``: each graph's nodes by their last channel, largest
    first (a stable sort), padding nodes last."""
    key = torch.where(nmask, h[..., -1], float('-inf'))
    return torch.argsort(-key, dim=1, stable=True)[:, :self.k]

  def forward(self, z, ei, em, nmask):
    """Logits ``[B]``."""
    b, n = z.shape
    x = self.z_embed(z.reshape(-1).to(torch.int64))
    shift = (torch.arange(b, device=ei.device, dtype=ei.dtype) * n)[:, None]
    ei = torch.where(ei >= 0, ei + shift[:, None], -1)
    ei = ei.permute(1, 0, 2).reshape(2, -1)
    em = em.reshape(-1)
    xs = []
    for i in range(self.num_layers):
      x = torch.tanh(getattr(self, f'gcn{i}')(x, ei, em))
      xs.append(x)
    xs.append(torch.tanh(self.gcn_last(x, ei, em)))
    h = torch.cat(xs, -1).reshape(b, n, -1)
    order = self.sort_order(h, nmask)
    pooled = h.gather(1, order[..., None].expand(-1, -1, h.shape[-1])) * \
        nmask.gather(1, order)[..., None].to(h.dtype)
    c = torch.relu(self.conv1(pooled))                  # [B, k, 16]
    c = self.pool(c.transpose(1, 2))                    # [B, 16, k // 2]
    c = torch.relu(self.conv2(c))                       # [B, 32, k // 2]
    f = torch.relu(self.mlp1(c.transpose(1, 2).reshape(b, -1)))
    return self.mlp2(f)[:, 0]


def make_graph(args):
  """The JAX example's Cora-scale community graph and link splits, draw
  for draw: ``(graph edge index, train pos, train neg, test pos, test
  neg)``."""
  rng = np.random.default_rng(0)
  n = args.num_nodes
  e = n * 6
  rows = rng.integers(0, n, e)
  intra = rng.random(e) < 0.85
  cols = np.where(intra, (rows + 8 * rng.integers(0, n // 8, e)) % n,
                  rng.integers(0, n, e))
  keep = rows != cols
  und = np.stack([np.concatenate([rows[keep], cols[keep]]),
                  np.concatenate([cols[keep], rows[keep]])])
  e_und = und.shape[1] // 2
  perm = rng.permutation(e_und)
  n_test = args.num_links
  test_pos = und[:, perm[:n_test]]
  train_pos = und[:, perm[n_test:n_test + args.num_links]]
  graph_edges_idx = perm[n_test:]          # test edges left out
  ge = np.concatenate([graph_edges_idx, graph_edges_idx + e_und])
  graph_ei = und[:, ge]
  edge_set = {(int(r), int(c)) for r, c in und.T}

  def sample_negs(k):
    out = []
    while len(out) < k:
      r, c = int(rng.integers(0, n)), int(rng.integers(0, n))
      if r != c and (r, c) not in edge_set:
        out.append((r, c))
    return np.array(out, np.int64).T

  train_neg = sample_negs(args.num_links)
  test_neg = sample_negs(n_test)
  return graph_ei, train_pos, train_neg, test_pos, test_neg


def extract(sampler, links, y, args):
  """Per link its enclosing subgraph, padded: ``[z, edge_index,
  edge_mask, node mask, label]`` stacked over the links (numpy)."""
  import graphlearn_tpu_torch as gtt
  xs, eis, ems, nms, ys = [], [], [], [], []
  for src, dst in links.T:
    out = sampler.subgraph(
        gtt.sampler.NodeSamplerInput(np.array([src, dst]))).trim()
    node, r, c = np.asarray(out.node), np.asarray(out.row), \
        np.asarray(out.col)
    mapping = out.metadata['mapping']
    mapping = (mapping.cpu().numpy() if torch.is_tensor(mapping)
               else np.asarray(mapping))
    s_l, d_l = int(mapping[0]), int(mapping[1])
    # remove the target link itself (both directions)
    m = ~(((r == s_l) & (c == d_l)) | ((r == d_l) & (c == s_l)))
    r, c = r[m], c[m]
    z = np.minimum(drnl_node_labeling(r, c, len(node), s_l, d_l), Z_CAP - 1)
    # pad to the caps (the rare overflow truncated)
    nn_ = min(len(node), args.node_cap)
    ne = min(len(r), args.edge_cap)
    x = np.zeros((args.node_cap,), np.int32)
    x[:nn_] = z[:nn_]
    ei = np.full((2, args.edge_cap), -1, np.int32)
    sel = (r < nn_) & (c < nn_)
    r2, c2 = r[sel][:ne], c[sel][:ne]
    ei[0, :len(r2)] = r2
    ei[1, :len(r2)] = c2
    xs.append(x)
    eis.append(ei)
    ems.append(ei[0] >= 0)
    nms.append(np.arange(args.node_cap) < nn_)
    ys.append(y)
  return [np.stack(a) for a in (xs, eis, ems, nms, ys)]


def make_step(model, optimizer):
  """``step(batch) -> loss`` (a detached 0-d device tensor): sigmoid
  binary cross-entropy of the logits against ``y``, averaged, one Adam
  step. Nothing is read back to the host."""

  def step(batch):
    optimizer.zero_grad()
    logits = model(batch['z'], batch['ei'], batch['em'], batch['nm'])
    loss = F.binary_cross_entropy_with_logits(logits, batch['y'].float())
    loss.backward()
    optimizer.step()
    return loss.detach()

  return step


def run(args, params=None):
  """Extract, train and evaluate as the JAX example does; returns
  ``(result, losses)``. ``params``: flax DGCNN parameters to start from
  (numpy leaves; default: torch's initialisation from ``--seed``)."""
  import graphlearn_tpu_torch as gtt
  from graphlearn_tpu_torch.models import convert
  from graphlearn_tpu_torch.models import train as train_lib
  from graphlearn_tpu_torch.utils import resolve_device
  device = resolve_device(args.device)
  graph_ei, train_pos, train_neg, test_pos, test_neg = make_graph(args)
  graph = gtt.data.Graph(gtt.data.Topology(graph_ei,
                                           num_nodes=args.num_nodes),
                         mode='CPU', device=device)
  sampler = gtt.sampler.NeighborSampler(graph, args.fanout, seed=0,
                                        device=device)
  t0 = time.time()
  tr = [np.concatenate(p) for p in zip(extract(sampler, train_pos, 1, args),
                                       extract(sampler, train_neg, 0, args))]
  te = [np.concatenate(p) for p in zip(extract(sampler, test_pos, 1, args),
                                       extract(sampler, test_neg, 0, args))]
  extract_s = time.time() - t0
  model = DGCNN(k=args.sortpool_k, device=device,
                generator=torch.Generator().manual_seed(args.seed))
  if params is not None:
    model.load_state_dict(convert.params_from_flax(params, model))
  state = train_lib.create_train_state(model, lr=1e-3)
  step = make_step(model, state.optimizer)
  shuffle_rng = np.random.default_rng(1)   # advances across epochs

  def batches(data, shuffle):
    z, ei, em, nm, y = data
    order = (shuffle_rng.permutation(len(y)) if shuffle
             else np.arange(len(y)))
    for i in range(0, len(y) - args.batch_size + 1, args.batch_size):
      sel = order[i:i + args.batch_size]
      yield {k: torch.as_tensor(v[sel]).to(device)
             for k, v in zip(('z', 'ei', 'em', 'nm', 'y'), data)}

  losses = []
  model.train()
  for _ in range(args.epochs):
    for b in batches(tr, shuffle=True):
      losses.append(step(b))
  model.eval()
  scores, labels = [], []
  with torch.no_grad():
    for b in batches(te, shuffle=False):
      scores.append(model(b['z'], b['ei'], b['em'], b['nm']).cpu().numpy())
      labels.append(b['y'].cpu().numpy())
  s = np.concatenate(scores)
  lab = np.concatenate(labels)
  order = np.argsort(s, kind='stable')
  ranks = np.empty_like(order, np.float64)
  ranks[order] = np.arange(1, len(s) + 1)
  n_pos = int((lab > 0.5).sum())
  n_neg = len(lab) - n_pos
  auc = (ranks[lab > 0.5].sum() - n_pos * (n_pos + 1) / 2) / \
      max(n_pos * n_neg, 1)
  losses = [float(v) for v in losses]      # the host reads: after training
  return {
      'model': 'SEAL-DGCNN', 'num_nodes': args.num_nodes,
      'links_per_split': args.num_links, 'epochs': args.epochs,
      'extract_s': round(extract_s, 1),
      'first_loss': round(losses[0], 4),
      'final_loss': round(losses[-1], 4),
      'test_auc': round(float(auc), 4),
  }, losses


def parser():
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--num-nodes', type=int, default=1000)
  ap.add_argument('--num-links', type=int, default=400,
                  help='positive links per split-source (same # negatives)')
  ap.add_argument('--batch-size', type=int, default=32)
  ap.add_argument('--fanout', type=int, nargs='+', default=[8, 8])
  ap.add_argument('--node-cap', type=int, default=96)
  ap.add_argument('--edge-cap', type=int, default=768)
  ap.add_argument('--sortpool-k', type=int, default=30)
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
