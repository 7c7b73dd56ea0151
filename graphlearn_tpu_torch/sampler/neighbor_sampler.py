"""Multi-hop neighbor sampler, homogeneous: the tree and merge engines.

Counterpart of ``graphlearn_tpu/sampler/neighbor_sampler.py`` for
uniform sampling. The JAX package compiles the whole multi-hop sample
into one program (``_fused_homo_fn``); PyTorch runs eagerly, so the same
program is a Python loop over hops, over static capacities:

- ``dedup='tree'`` (alias 'none'): each hop is the fused CSR hop
  (``ops.sample_hop_fused``: threefry draw in torch, the adjacency
  gather in the ``sample_hop`` kernel on the card) followed by the
  positional tree inducer; hop i's frontier is ``batch_cap *
  prod(fanouts[:i])`` slots.
- ``dedup='auto'`` (the default, as in the JAX package; aliases 'map',
  'sort', 'merge'): exact dedup. Each level is ``ops.sample_level_fused``
  (the draw in torch, then picks and relabel map in the ``sample_level``
  kernel on the card, or the merge inducer on the CPU). ``frontier_caps``
  clamps the per-hop frontiers (``sampler.calibrate``); a batch whose
  new nodes exceed a cap is truncated and raises the on-device
  ``metadata['overflow']`` flag.

The PRNG stream is the JAX package's: one key per batch by ``fold_in``
of a host call counter into the base key, one key per hop by ``split``.
So the port's batches equal the JAX sampler's, id for id.

Edge direction: ``row`` is the neighbor (message source) local index and
``col`` the seed (target), as in the JAX package.
"""
import copy
from typing import Optional

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..data import Graph
from .base import NodeSamplerInput, SamplerOutput


def _round_up(n: int, multiple: int = 8) -> int:
  return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def capacity_plan(batch_cap: int, fanouts, frontier_caps=None):
  """Per-hop frontier capacities ``[b, c1, ...]``: ``c_{i+1} = c_i * k_i``
  clamped by ``frontier_caps[i]`` (the calibrated post-dedup caps of
  ``sampler.calibrate``). The JAX package's node_budget clamp comes with
  the sampling-menu slice."""
  caps = [batch_cap]
  for i, k in enumerate(fanouts):
    nxt = caps[-1] * k
    if frontier_caps is not None and i < len(frontier_caps) and \
        frontier_caps[i] is not None:
      nxt = min(nxt, frontier_caps[i])
    caps.append(nxt)
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


def merge_layout_from_caps(caps, fanouts):
  """(prefix_offsets, edge_offsets) of the merge-engine layout:
  ``prefix_offsets[i]`` is the clamped occupancy bound before hop i (the
  inducer's ``prefix_cap``), the node capacity ``sum(caps)`` last; edge
  block i is ``caps[i] * k`` wide. Shared by the sampler and
  ``models.train.merge_hop_offsets``."""
  node_offs = [caps[0]]
  edge_offs = []
  tot_e = 0
  for i, k in enumerate(fanouts):
    tot_e += caps[i] * k
    edge_offs.append(tot_e)
    node_offs.append(node_offs[-1] + caps[i + 1])
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
      '(the port samples homogeneous graphs uniformly, with the tree and '
      'merge engines)')


class NeighborSampler:
  """Fanout neighbor sampling over a device CSR.

  Args:
    graph: a homogeneous ``Graph``.
    num_neighbors: per-hop fanouts.
    device: torch device (None means the card); must be the graph's.
    seed: PRNG seed (None = 0).
    dedup: 'auto' (default; also 'map', 'sort', 'merge') runs the merge
      exact-dedup engine, 'tree' (or its alias 'none') the positional
      tree engine. The legacy 'map_table' / 'sort_legacy' engines come
      with the sampling-menu slice.
    frontier_caps: per-hop post-dedup frontier caps (a list, e.g. from
      ``sampler.calibrate.estimate_frontier_caps``); exact-dedup only.

  The options of the JAX sampler that other slices port raise
  ``NotImplementedError``.
  """

  def __init__(self, graph: Graph, num_neighbors=None, device=None,
               with_edge: bool = False, with_weight: bool = False,
               strategy: str = 'random', seed: Optional[int] = None,
               node_budget=None, dedup: str = 'auto', padded_window=None,
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
    if with_edge:
      raise _later('with_edge', 'sampling-menu')
    if isinstance(num_neighbors, dict):
      raise _later('per-edge-type fanouts', 'hetero')
    self.dedup = dedup
    mode = self._dedup_mode()
    if frontier_caps is not None:
      if mode == 'tree':
        # tree frontiers are un-deduped (positional): clamping them with
        # post-dedup caps would silently truncate most samples
        raise ValueError('frontier_caps requires an exact-dedup mode '
                         '(auto/map/sort/merge), not the tree engine')
      if isinstance(frontier_caps, dict):
        raise ValueError('dict-form frontier_caps is hetero-only; pass '
                         'a per-hop list on homogeneous graphs')
      frontier_caps = tuple(frontier_caps)
    self.frontier_caps = frontier_caps
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'graph lives on {graph.device}, sampler asked for '
                       f'{self.device}')
    self.graph = graph
    self.num_neighbors = list(num_neighbors)
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    self._call_count = 0    # host-side PRNG stream position

  def _dedup_mode(self) -> str:
    """The engine: 'tree' for 'tree'/'none', 'merge' for
    'map'/'sort'/'merge'/'auto' (as in the JAX package)."""
    if self.dedup in ('tree', 'none'):
      return 'tree'
    if self.dedup in ('map', 'sort', 'merge', 'auto'):
      return 'merge'
    if self.dedup in ('map_table', 'sort_legacy'):
      raise _later(f'dedup={self.dedup!r}', 'sampling-menu')
    raise ValueError(f'unknown dedup mode {self.dedup!r}')

  def hop_caps(self, batch_cap: int):
    """The resolved per-hop frontier capacities: a batch truncated under
    calibrated caps has ``num_sampled_nodes[i+1] > hop_caps[i+1]``."""
    return capacity_plan(batch_cap, self.num_neighbors,
                         frontier_caps=self.frontier_caps)

  @property
  def clamped_exact(self) -> bool:
    """True when the merge engine runs under calibrated frontier_caps:
    the configuration whose batches can be truncated, which the loaders'
    overflow guard watches."""
    return self.frontier_caps is not None and self._dedup_mode() == 'merge'

  def uncapped_clone(self) -> 'NeighborSampler':
    """A sampler sharing this one's graph and PRNG base, without
    frontier_caps: the full-capacity replay target of the overflow
    guard's 'recompute' policy."""
    clone = copy.copy(self)
    clone.frontier_caps = None
    return clone

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
    """The multi-hop program (``_fused_homo_fn``)."""
    fanouts = self.num_neighbors
    batch_cap = seeds.shape[0]
    caps = self.hop_caps(batch_cap)
    g = self.graph
    merge = self._dedup_mode() == 'merge'
    if merge:
      state, frontier, fmask, inv = ops.init_node_merge(
          seeds, seed_mask, capacity=sum(caps))
      node_offs, _ = merge_layout_from_caps(caps, fanouts)
    else:
      state, frontier, fmask, inv = ops.init_node_tree(
          seeds, seed_mask, capacity=_tree_node_cap(caps, fanouts))
      node_offs, _ = tree_layout_from_caps(caps, fanouts)
    fidx = torch.arange(batch_cap, dtype=torch.int32, device=seeds.device)
    rows, cols, emasks = [], [], []
    nodes_per_hop = [state.num_nodes]
    edges_per_hop = []
    # on-device truncation flag: True iff a clamped hop found more new
    # nodes than its cap kept (constant False on unclamped plans)
    overflow = torch.zeros((), dtype=torch.bool, device=seeds.device)
    keys = trandom.split(key, len(fanouts))
    for i, k in enumerate(fanouts):
      if merge:
        state, out, _, _ = ops.sample_level_fused(
            g.indptr, g.indices, None, frontier, fmask, k, keys[i], state,
            fidx, meta=g.csr_meta, prefix_cap=node_offs[i],
            max_new=caps[i + 1], final=(i + 1 == len(fanouts)))
        if caps[i + 1] < caps[i] * k:
          overflow = overflow | (out['num_new'] > caps[i + 1])
      else:
        nbrs, _, m = ops.sample_hop_fused(
            g.indptr, g.indices, None, frontier, fmask, k, keys[i],
            meta=g.csr_meta)
        state, out = ops.induce_next_tree(state, fidx, nbrs, m,
                                          node_offs[i])
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
                num_sampled_edges=edges_per_hop, seed_inverse=inv,
                overflow=overflow)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        batch_cap: Optional[int] = None,
                        key=None) -> SamplerOutput:
    """Multi-hop sample from seed nodes; seeds are padded to
    ``batch_cap`` (default: the seed count rounded up to 8).

    ``key``: explicit per-batch key (default: the next key of the
    sampler's own fold_in stream). The overflow guard replays a
    truncated batch at full capacities with the same key."""
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
        metadata={'seed_inverse': res['seed_inverse'], 'seed_mask': mask,
                  'overflow': res['overflow']})
