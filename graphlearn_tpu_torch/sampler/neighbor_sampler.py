"""Multi-hop neighbor sampler, homogeneous, tree engine.

Counterpart of ``graphlearn_tpu/sampler/neighbor_sampler.py`` for
``dedup='tree'`` uniform sampling. The JAX package compiles the whole
multi-hop sample into one program (``_fused_homo_fn``); PyTorch runs
eagerly, so the same program is a Python loop over hops. Each hop is the
fused CSR hop (``ops.sample_hop_fused``: threefry draw in torch, the
adjacency gather in the ``sample_hop`` kernel on the card) followed by
the positional tree inducer. Capacities are static: hop i's frontier is
``batch_cap * prod(fanouts[:i])`` slots.

The PRNG stream is the JAX package's: one key per batch by ``fold_in``
of a host call counter into the base key, one key per hop by ``split``.
So the port's batches equal the JAX sampler's, id for id.

Edge direction: ``row`` is the neighbor (message source) local index and
``col`` the seed (target), as in the JAX package.
"""
from typing import Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..data import Graph
from .base import NodeSamplerInput, SamplerOutput


def _round_up(n: int, multiple: int = 8) -> int:
  return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def capacity_plan(batch_cap: int, fanouts):
  """Per-hop frontier capacities ``[b, b*k0, b*k0*k1, ...]``. The JAX
  package's node_budget and frontier_caps clamps come with the slices
  that port those options."""
  caps = [batch_cap]
  for k in fanouts:
    caps.append(caps[-1] * k)
  return caps


def tree_layout_from_caps(caps, fanouts):
  """(hop_node_offsets, hop_edge_offsets) of the tree positional layout
  for a capacity plan."""
  node_offs = [caps[0]]
  edge_offs = []
  total_e = 0
  for i, k in enumerate(fanouts):
    seg = caps[i] * k
    total_e += seg
    edge_offs.append(total_e)
    node_offs.append(node_offs[-1] + seg)
  return tuple(node_offs), tuple(edge_offs)


def tree_layout(batch_cap: int, fanouts):
  """(hop_node_offsets, hop_edge_offsets): the one layout plan shared by
  the sampler's buffers and the layered model forward."""
  return tree_layout_from_caps(capacity_plan(batch_cap, fanouts), fanouts)


def _tree_node_cap(caps, fanouts) -> int:
  """Positional layout size: seeds block + one full block per hop."""
  return tree_layout_from_caps(caps, fanouts)[0][-1]


def _later(what: str, slice_name: str):
  return NotImplementedError(
      f'{what} is not ported yet: it comes with the {slice_name} slice '
      '(this slice ports homogeneous uniform tree sampling)')


class NeighborSampler:
  """Fanout neighbor sampling over a device CSR (tree engine).

  Args:
    graph: a homogeneous ``Graph``.
    num_neighbors: per-hop fanouts.
    device: torch device (None means the card); must be the graph's.
    seed: PRNG seed (None = 0).
    dedup: 'tree' (or its alias 'none'); the exact-dedup engines come
      with the merge slice.

  The options of the JAX sampler that other slices port raise
  ``NotImplementedError``.
  """

  def __init__(self, graph: Graph, num_neighbors=None, device=None,
               with_edge: bool = False, with_weight: bool = False,
               strategy: str = 'random', seed: Optional[int] = None,
               node_budget=None, dedup: str = 'tree', padded_window=None,
               frontier_caps=None):
    from ..utils import resolve_device
    if isinstance(graph, dict):
      raise _later('heterogeneous sampling', 'hetero')
    if with_weight:
      raise _later('weighted sampling', 'sampling-menu')
    if strategy != 'random':
      raise _later(f'strategy={strategy!r}', 'sampling-menu')
    if padded_window is not None:
      raise _later('padded_window', 'sampling-menu')
    if node_budget is not None:
      raise _later('node_budget', 'sampling-menu')
    if dedup not in ('tree', 'none'):
      raise _later(f'dedup={dedup!r}', 'merge-engine')
    if frontier_caps is not None:
      raise _later('frontier_caps', 'merge-engine')
    if with_edge:
      raise _later('with_edge', 'sampling-menu')
    if isinstance(num_neighbors, dict):
      raise _later('per-edge-type fanouts', 'hetero')
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'graph lives on {graph.device}, sampler asked for '
                       f'{self.device}')
    self.graph = graph
    self.num_neighbors = list(num_neighbors)
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    self._call_count = 0    # host-side PRNG stream position

  def _next_key(self):
    """Per-call key: fold_in of the host counter into the base key."""
    self._call_count += 1
    return trandom.fold_in(self._key, self._call_count)

  def state_dict(self):
    return {'call_count': int(self._call_count),
            'base_key': self._key.tolist()}

  def load_state_dict(self, state):
    if 'call_count' not in state:
      raise ValueError(
          f'checkpoint sampler state {sorted(state)} was written by a '
          'different sampler type; resuming would diverge')
    self._call_count = int(state['call_count'])
    if 'base_key' in state:
      self._key = torch.as_tensor(state['base_key'], dtype=torch.int64)

  def _sample(self, seeds, seed_mask, key):
    """The multi-hop program (``_fused_homo_fn`` for mode 'tree')."""
    fanouts = self.num_neighbors
    batch_cap = seeds.shape[0]
    caps = capacity_plan(batch_cap, fanouts)
    g = self.graph
    state, frontier, fmask, inv = ops.init_node_tree(
        seeds, seed_mask, capacity=_tree_node_cap(caps, fanouts))
    fidx = torch.arange(batch_cap, dtype=torch.int32, device=seeds.device)
    rows, cols, emasks = [], [], []
    nodes_per_hop = [state.num_nodes]
    edges_per_hop = []
    keys = trandom.split(key, len(fanouts))
    node_offs, _ = tree_layout_from_caps(caps, fanouts)
    for i, k in enumerate(fanouts):
      nbrs, _, m = ops.sample_hop_fused(
          g.indptr, g.indices, None, frontier, fmask, k, keys[i],
          meta=g.csr_meta)
      state, out = ops.induce_next_tree(state, fidx, nbrs, m, node_offs[i])
      rows.append(out['cols'])     # message direction: neighbor -> seed
      cols.append(out['rows'])
      emasks.append(out['edge_mask'])
      nodes_per_hop.append(out['num_new'])
      edges_per_hop.append(out['edge_mask'].sum().to(torch.int32))
      nxt = caps[i + 1]
      frontier = out['frontier'][:nxt]
      fidx = out['frontier_idx'][:nxt]
      fmask = out['frontier_mask'][:nxt]
    return dict(node=state.nodes, num_nodes=state.num_nodes,
                row=torch.cat(rows), col=torch.cat(cols),
                edge_mask=torch.cat(emasks), num_sampled_nodes=nodes_per_hop,
                num_sampled_edges=edges_per_hop, seed_inverse=inv)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        batch_cap: Optional[int] = None,
                        key=None) -> SamplerOutput:
    """Multi-hop sample from seed nodes; seeds are padded to
    ``batch_cap`` (default: the seed count rounded up to 8).

    ``key``: explicit per-batch key (default: the next key of the
    sampler's own fold_in stream)."""
    seeds = np.asarray(inputs.node).reshape(-1)
    n = seeds.shape[0]
    cap = batch_cap or _round_up(n)
    padded = np.zeros((cap,), dtype=np.int32)
    padded[:n] = seeds
    mask = np.arange(cap) < n
    if key is None:
      key = self._next_key()
    seeds_d = torch.as_tensor(padded).to(self.device)
    mask_d = torch.as_tensor(mask).to(self.device)
    res = self._sample(seeds_d, mask_d, key)
    return SamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=None, edge_mask=res['edge_mask'],
        batch=seeds_d, batch_size=n,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        input_type=inputs.input_type,
        metadata={'seed_inverse': res['seed_inverse'], 'seed_mask': mask})
