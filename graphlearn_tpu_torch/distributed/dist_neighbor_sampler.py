"""Distributed sampling over a sharded graph: node, link, subgraph,
homogeneous and typed.

Counterpart of ``graphlearn_tpu/distributed/dist_neighbor_sampler.py``.
JAX compiles
the whole multi-hop sample into one ``shard_map`` program; here it is a
Python loop over hops and over the mesh's local shards (all P on a
one-process ``ShardMesh``, this rank's one under a process group), with
the mesh's collectives between. Per hop, per shard:

  1. ``dest = node_pb[frontier]``
  2. pack the frontier into ``[P, cap]`` buckets (``ops.route_slots``,
     ``ops.scatter_to_buckets``)
  3. ``mesh.all_to_all`` (the requests)
  4. sample the received requests over the shard's local CSR
     (``ops.uniform_sample_local``: one launch of the hop kernel K3 on a
     card; or ``ops.weighted_sample_local``)
  5. ``mesh.all_to_all`` back (the responses)
  6. un-permute into frontier order (``ops.gather_from_buckets``)
  7. dedup and relabel into the shard's batch (the tree or merge
     inducer)

The receiving shard samples its flattened ``[P * cap]`` request buffer
in source-major order with one ``[P * cap, k]`` draw, so a request's draw
depends on its (source, slot) position and on ``cap``: the buckets are
built exactly as JAX builds them, and ``cap`` is chosen as JAX chooses
it: ``exchange_capacity(bf, P, bucket_frac)``, or the full width when
the overflow summed over all shards is non-zero. JAX takes that branch
under ``lax.cond`` on the device; here the width is a shape, so the
verdict is read on the host: one read per hop whose fractional capacity
is below the full width (``dist_context.verdict_syncs``), none with
``bucket_frac=None``. That is the path's only host read.

Keys: a batch's per-shard keys are ``split(fold_in(base_key, count),
P)``; a shard's hop keys ``split(key, max(1, len(fanouts)))``; the port's
threefry gives JAX's words bit for bit. So a batch equals JAX's id for
id.

``dedup='tree'`` ('none') is the positional tree inducer; 'sort', 'map'
and 'merge' all run the merge inducer (``_inducer_for('merge')``).

Link sampling draws shard-local negatives against each shard's own CSR
(``ops.random_negative_sample_local``: the negative kernel's local
entry, which counts the shard's rows on the device) and samples the
union of endpoints and negatives. The induced subgraph gathers every
shard's node set to every shard (``ShardMesh.all_gather``), extracts
each set's local edges (``ops.node_subgraph_local``) and sends them back
(``all_to_all``). The typed engine (``_hetero_engine``) runs one
exchange hop per (hop, edge type) item of ``_hetero_plan`` under the
item's key of ``split(shard key, hops * |edge types|)`` and induces
into per-node-type states.
"""
import copy
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..ops.route import exchange_capacity, round8
from ..sampler import (EdgeSamplerInput, HeteroSamplerOutput,
                       NodeSamplerInput, SamplerOutput)
from ..sampler.neighbor_sampler import _jax_dtype
from ..typing import reverse_edge_type
from .dist_context import ShardMesh, count_verdict_sync
from .dist_feature import DistFeature, exchange_width
from .dist_graph import DistGraph, DistHeteroGraph, _to

def _local_sample(garr, l, flat, fm, k, key, weighted: bool):
  """One shard's fanout sample over its local CSR (local index ``l``)."""
  if weighted:
    return ops.weighted_sample_local(
        garr['row_ids'][l], garr['indptr'][l], garr['indices'][l],
        garr['wcum'][l], flat, fm, k, key)
  return ops.uniform_sample_local(
      garr['row_ids'][l], garr['indptr'][l], garr['indices'][l], flat, fm,
      k, key)


def _exchange_hop_hier(mesh: ShardMesh, garr, pb, frontier, fmask, k, keys,
                       with_edge: bool, weighted: bool, bucket_frac):
  """The hierarchical two-stage hop of a 2-axis ``(S, C)`` mesh (JAX's
  ``_exchange_hop_hier``): the requests go full width along 'chip' to
  their owner's chip column, then in ``[S, cap2]`` buckets along
  'slice' to their owner, sampled there, and the responses retrace both
  transposes. ``cap2`` is ``round8(bucket_frac * bf / S)`` (the mean
  valid load of a slice bucket, with slack), or the full ``C * bf``. When
  ``cap2`` is below that, the overflow summed over the mesh is read on
  the host (a counted verdict, where JAX decides under ``lax.cond``) and
  an overflowing hop takes the flat full-width exchange instead."""
  s_sz, c_sz = mesh.shape
  nparts = mesh.num_partitions
  nloc, bf = frontier.shape
  dest = torch.where(fmask, pb[frontier.clamp(min=0).long()], nparts)
  c_dst = torch.where(fmask, dest % c_sz, c_sz)
  r1 = [ops.route_slots(c_dst[l], fmask[l], capacity=bf) for l in range(nloc)]
  slot1 = torch.stack([r[0] for r in r1])
  ok1 = torch.stack([r[1] for r in r1])
  send1 = torch.stack([
      ops.scatter_to_buckets(frontier[l], c_dst[l], slot1[l], ok1[l], c_sz,
                             bf) for l in range(nloc)])
  mid = mesh.all_to_all(send1, 'chip').reshape(nloc, -1)   # [L, C * bf]
  mid_mask = mid >= 0
  mdest = torch.where(mid_mask, pb[mid.clamp(min=0).long()] // c_sz, s_sz)
  r2 = [ops.route_slots(mdest[l], mid_mask[l], capacity=c_sz * bf)
        for l in range(nloc)]
  slot2 = torch.stack([r[0] for r in r2])
  ok2f = torch.stack([r[1] for r in r2])
  if bucket_frac is None or s_sz <= 1:
    cap2 = c_sz * bf
  else:
    cap2 = min(c_sz * bf, round8(int(bucket_frac * bf / s_sz)))
  if cap2 < c_sz * bf:
    over = (mid_mask & (slot2 >= cap2)).sum(1).to(torch.int32)
    count_verdict_sync()
    if int(mesh.psum(over)[0]) != 0:
      return _exchange_hop(mesh, garr, pb, frontier, fmask, k, keys,
                           with_edge, weighted, bucket_frac=None,
                           hier=False)
  ok2 = ok2f & (slot2 < cap2)
  send2 = torch.stack([
      ops.scatter_to_buckets(mid[l], mdest[l], slot2[l], ok2[l], s_sz, cap2)
      for l in range(nloc)])
  req2 = mesh.all_to_all(send2, 'slice')                     # [L, S, cap2]
  nbrs, masks, edges = [], [], []
  for l in range(nloc):
    flat = req2[l].reshape(-1)
    n, epos, m = _local_sample(garr, l, flat, flat >= 0, k, keys[l],
                               weighted)
    nbrs.append(n)
    masks.append(m)
    if with_edge:
      edges.append(_edge_ids(garr['eids'][l], epos, m))

  def back(vals, fill):
    r = mesh.all_to_all(torch.stack(vals).reshape(nloc, s_sz, cap2, k),
                        'slice')
    b2 = torch.stack([ops.gather_from_buckets(r[l], mdest[l], slot2[l],
                                              ok2[l], fill=fill)
                      for l in range(nloc)])
    r = mesh.all_to_all(b2.reshape(nloc, c_sz, bf, k), 'chip')
    return torch.stack([ops.gather_from_buckets(r[l], c_dst[l], slot1[l],
                                                ok1[l], fill=fill)
                        for l in range(nloc)])

  back_n = back(nbrs, ops.FILL)
  back_m = back(masks, False) & ok1[:, :, None]
  back_e = back(edges, ops.FILL) if with_edge else None
  return back_n, back_m, back_e


def _edge_ids(eids, epos, m):
  """Global edge ids of the sampled positions (-1 where masked)."""
  if eids.shape[0] == 0:
    return torch.full(m.shape, -1, dtype=torch.int64, device=m.device)
  return torch.where(m, eids[torch.where(m, epos, 0).long()], -1)


def _exchange_hop(mesh: ShardMesh, garr, pb, frontier, fmask, k, keys,
                  with_edge: bool, weighted: bool = False,
                  bucket_frac=2.0, hier: bool = True):
  """One cross-shard hop of the ``[L, bf]`` frontiers: route by the
  partition book, exchange the requests, sample them on their owners
  (``keys[l]``: shard l's hop key), exchange the responses, un-permute.
  Returns ``(nbrs, mask, edges or None)``, each ``[L, bf, k]``.

  With ``bucket_frac=None`` every bucket is the full frontier width and
  can never overflow. With a fraction the buckets are ``round8(frac *
  bf / P)`` wide, and the hop falls back to the full width when any
  shard's buckets overflow (the one counted host read). On a 2-axis mesh
  the hop is :func:`_exchange_hop_hier` (``hier=False``: its flat
  fallback)."""
  if hier and mesh.shape is not None:
    return _exchange_hop_hier(mesh, garr, pb, frontier, fmask, k, keys,
                              with_edge, weighted, bucket_frac)
  nparts = mesh.num_partitions
  nloc, bf = frontier.shape
  dest = torch.where(fmask, pb[frontier.clamp(min=0).long()], nparts)
  routes = [ops.route_slots(dest[l], fmask[l], capacity=bf)
            for l in range(nloc)]
  slot = torch.stack([r[0] for r in routes])
  ok = torch.stack([r[1] for r in routes])
  cap_small = exchange_capacity(bf, nparts, bucket_frac)
  over = (None if cap_small >= bf else
          (fmask & (slot >= cap_small)).sum(1).to(torch.int32))
  cap = exchange_width(mesh, over, bf, cap_small)
  okc = ok & (slot < cap)
  send = torch.stack([
      ops.scatter_to_buckets(frontier[l], dest[l], slot[l], okc[l], nparts,
                             cap) for l in range(nloc)])
  req = mesh.all_to_all(send)                          # [L, P, cap]
  nbrs, masks, edges = [], [], []
  for l in range(nloc):
    flat = req[l].reshape(-1)
    n, epos, m = _local_sample(garr, l, flat, flat >= 0, k, keys[l],
                               weighted)
    nbrs.append(n.reshape(nparts, cap, k))
    masks.append(m.reshape(nparts, cap, k))
    if with_edge:
      edges.append(_edge_ids(garr['eids'][l], epos, m).reshape(nparts, cap,
                                                               k))
  resp_n = mesh.all_to_all(torch.stack(nbrs))          # [L, P, cap, k]
  resp_m = mesh.all_to_all(torch.stack(masks))
  resp_e = mesh.all_to_all(torch.stack(edges)) if with_edge else None
  back_n, back_m, back_e = [], [], []
  for l in range(nloc):
    back_n.append(ops.gather_from_buckets(resp_n[l], dest[l], slot[l],
                                          okc[l]))
    back_m.append(ops.gather_from_buckets(resp_m[l], dest[l], slot[l],
                                          okc[l], fill=False)
                  & okc[l][:, None])
    if with_edge:
      back_e.append(ops.gather_from_buckets(resp_e[l], dest[l], slot[l],
                                            okc[l]))
  return (torch.stack(back_n), torch.stack(back_m),
          torch.stack(back_e) if with_edge else None)


def _homo_hop_loop(mesh: ShardMesh, gdev, pb, seeds, smask, keys, fanouts,
                   caps, node_cap: int, with_edge: bool, weighted: bool,
                   dedup: str = 'merge', bucket_frac=2.0, hop_keys=None):
  """The multi-hop engine over the ``[L, b]`` seed blocks and ``[L, 2]``
  host keys: dedup the seeds, expand hop by hop through
  :func:`_exchange_hop` and the inducer. Returns the per-shard result
  dict, each value stacked ``[L, ...]``. ``hop_keys``: the ``[L, hops,
  2]`` keys already split, on the seeds' device (a chunk trainer's,
  drawn by ``ops.dist_step_keys``); ``keys`` is then unused."""
  from ..sampler.neighbor_sampler import (_inducer_for,
                                          merge_layout_from_caps,
                                          tree_layout_from_caps)
  nloc, b = seeds.shape
  dev = seeds.device
  if hop_keys is None:
    hop_keys = trandom.split(keys, max(1, len(fanouts)))   # [L, hops, 2]
    if dev.type == 'cuda':
      hop_keys = trandom.to_device(hop_keys, dev)
  init_seed, _, induce = _inducer_for(dedup)
  states, fronts, fmasks, invs = [], [], [], []
  for l in range(nloc):
    st, fr, fm, inv = init_seed(seeds[l], smask[l], capacity=node_cap)
    states.append(st)
    fronts.append(fr)
    fmasks.append(fm)
    invs.append(inv)
  frontier, fmask = torch.stack(fronts), torch.stack(fmasks)
  fidx = [torch.arange(b, dtype=torch.int32, device=dev)] * nloc
  rows = [[] for _ in range(nloc)]
  cols = [[] for _ in range(nloc)]
  emasks = [[] for _ in range(nloc)]
  edges = [[] for _ in range(nloc)]
  nodes_per_hop = [[st.num_nodes] for st in states]
  edges_per_hop = [[] for _ in range(nloc)]
  # the on-device truncation flag of clamped exact plans (calibrated
  # frontier_caps), summed over the mesh below: one verdict everywhere
  overflow = torch.zeros((nloc,), dtype=torch.bool, device=dev)
  if dedup == 'tree':
    node_offs, _ = tree_layout_from_caps(caps, fanouts)
  else:
    node_offs, _ = merge_layout_from_caps(caps, fanouts)
  clamped = [dedup == 'merge' and caps[i + 1] < caps[i] * k
             for i, k in enumerate(fanouts)]
  for i, k in enumerate(fanouts):
    nbrs, m, e = _exchange_hop(mesh, gdev, pb, frontier, fmask, k,
                               hop_keys[:, i], with_edge, weighted,
                               bucket_frac=bucket_frac)
    nxt = caps[i + 1]
    fronts, fmasks, news = [], [], []
    for l in range(nloc):
      states[l], out = induce(states[l], fidx[l], nbrs[l], m[l],
                              node_offs[i], final=(i + 1 == len(fanouts)),
                              max_new=nxt)
      rows[l].append(out['cols'])     # message direction: neighbour -> seed
      cols[l].append(out['rows'])
      emasks[l].append(out['edge_mask'])
      if with_edge:
        edges[l].append(torch.where(out['edge_mask'], e[l].reshape(-1), -1))
      nodes_per_hop[l].append(out['num_new'])
      edges_per_hop[l].append(out['edge_mask'].sum().to(torch.int32))
      news.append(out['num_new'])
      fronts.append(out['frontier'][:nxt])
      fidx[l] = out['frontier_idx'][:nxt]
      fmasks.append(out['frontier_mask'][:nxt])
    if clamped[i]:
      overflow = overflow | (torch.stack(news) > nxt)
    frontier, fmask = torch.stack(fronts), torch.stack(fmasks)
  if any(clamped):
    overflow = mesh.psum(overflow.to(torch.int32)) > 0
  if not fanouts:
    z32 = torch.zeros((0,), dtype=torch.int32, device=dev)
    for l in range(nloc):
      rows[l], cols[l] = [z32], [z32]
      emasks[l] = [torch.zeros((0,), dtype=torch.bool, device=dev)]
      edges_per_hop[l] = [torch.zeros((), dtype=torch.int32, device=dev)]
      edges[l] = [torch.zeros((0,), dtype=torch.int64, device=dev)]
  res = dict(
      node=torch.stack([st.nodes for st in states]),
      num_nodes=torch.stack([st.num_nodes for st in states]),
      row=torch.stack([torch.cat(r) for r in rows]),
      col=torch.stack([torch.cat(c) for c in cols]),
      edge_mask=torch.stack([torch.cat(e) for e in emasks]),
      seed_inverse=torch.stack(invs),
      num_sampled_nodes=torch.stack([torch.stack(n).to(torch.int32)
                                     for n in nodes_per_hop]),
      num_sampled_edges=torch.stack([torch.stack(n) for n in edges_per_hop]),
      overflow=overflow)
  if with_edge:
    res['edge'] = torch.stack([torch.cat(e) for e in edges])
  return res


def _subgraph_hop_loop(mesh: ShardMesh, gdev, pb, seeds, smask, keys,
                       fanouts, caps, node_cap: int, weighted: bool,
                       bucket_frac):
  """The subgraph path's optional hop expansion (JAX's legacy sort
  inducer, ``ops.init_node`` / ``ops.induce_next``, never clamped): the
  ``[L, node_cap]`` node buffers and their valid masks."""
  nloc, b = seeds.shape
  dev = seeds.device
  hop_keys = trandom.split(keys, len(fanouts))             # [L, hops, 2]
  if dev.type == 'cuda':
    hop_keys = trandom.to_device(hop_keys, dev)
  states, fronts, fmasks = [], [], []
  for l in range(nloc):
    st, uniq, umask, _ = ops.init_node(seeds[l], smask[l], capacity=node_cap)
    states.append(st)
    fronts.append(uniq)
    fmasks.append(umask)
  frontier, fmask = torch.stack(fronts), torch.stack(fmasks)
  fidx = [torch.arange(b, dtype=torch.int32, device=dev)] * nloc
  for i, k in enumerate(fanouts):
    nbrs, m, _ = _exchange_hop(mesh, gdev, pb, frontier, fmask, k,
                               hop_keys[:, i], False, weighted,
                               bucket_frac=bucket_frac)
    nxt = caps[i + 1]
    fronts, fmasks = [], []
    for l in range(nloc):
      states[l], out = ops.induce_next(states[l], fidx[l], nbrs[l], m[l])
      fronts.append(out['frontier'][:nxt])
      fidx[l] = out['frontier_idx'][:nxt]
      fmasks.append(out['frontier_mask'][:nxt])
    frontier, fmask = torch.stack(fronts), torch.stack(fmasks)
  arange = torch.arange(node_cap, device=dev)
  return (torch.stack([st.nodes for st in states]),
          torch.stack([arange < st.num_nodes for st in states]))


class DistNeighborSampler:
  """Per-shard batches from per-shard seed blocks over a ``DistGraph``
  or a ``DistHeteroGraph``.

  Args:
    dist_graph: ``DistGraph`` or ``DistHeteroGraph``.
    num_neighbors: per-hop fanouts (a ``{edge_type: fanouts}`` dict on a
      typed graph; None for pure induced subgraphs).
    mesh: a ``ShardMesh`` of ``num_partitions`` shards.
    dist_feature: optional ``DistFeature`` for ``collate`` (a ``{ntype:
      DistFeature}`` dict on a typed graph).
    with_edge: emit global edge ids.
    with_weight: edge-weight-biased sampling (over the shards' row CDFs).
    seed: PRNG seed.
    node_budget / frontier_caps: the capacity clamps of the single-device
      sampler (``frontier_caps`` for the exact modes only; a per-hop list,
      or a ``{edge_type: per-hop caps}`` dict on a typed graph).
    dedup: 'tree' ('none') or 'sort' / 'map' / 'merge' (exact).
    bucket_frac: exchange slack over the mean per-destination load
      (None: the full width).
    neg_strict: link sampling's shard-local negatives are then guaranteed
      non-edges where valid (``ops.random_negative_sample_local``).
  """

  def __init__(self, dist_graph: Union[DistGraph, DistHeteroGraph],
               num_neighbors, mesh,
               dist_feature: Optional[DistFeature] = None,
               with_edge: bool = False, seed: Optional[int] = None,
               node_budget: Optional[int] = None,
               collect_features: bool = False,
               with_weight: bool = False, dedup: str = 'sort',
               bucket_frac=2.0, neg_strict: bool = False,
               frontier_caps=None):
    self.graph = dist_graph
    self.is_hetero = dist_graph.is_hetero
    if num_neighbors is None:
      self.num_neighbors = []
    else:
      self.num_neighbors = (dict(num_neighbors)
                            if isinstance(num_neighbors, dict)
                            else list(num_neighbors))
    self.mesh = mesh
    self.dist_feature = dist_feature
    self.with_edge = with_edge
    self.with_weight = with_weight
    self.collect_features = collect_features and dist_feature is not None
    self.node_budget = node_budget
    self.bucket_frac = bucket_frac
    self.neg_strict = neg_strict
    dedup = 'tree' if dedup == 'none' else dedup
    if dedup in ('sort', 'map', 'merge'):
      dedup = 'merge'
    elif dedup != 'tree':
      raise ValueError(f'unknown dedup mode {dedup!r}; the distributed '
                       "engine supports 'sort'/'map'/'merge' (exact) and "
                       "'tree'")
    self.dedup = dedup
    if frontier_caps is not None:
      if isinstance(frontier_caps, str):
        raise ValueError(
            f'frontier_caps={frontier_caps!r}: the distributed engine '
            'takes explicit caps; calibrate on the host CSR with '
            'sampler.calibrate.estimate_frontier_caps (homo list; '
            'batch_size = the PER-SHARD seed width) or '
            'estimate_hetero_frontier_caps (hetero dict); '
            "'auto' exists on the local loaders only")
      if self.dedup == 'tree':
        raise ValueError('frontier_caps requires an exact-dedup mode '
                         "('sort'/'map'/'merge'); tree frontiers are "
                         'positional, use node_budget there')
    if frontier_caps is None:
      self.frontier_caps = None
    elif self.is_hetero:
      from ..sampler.calibrate import normalize_hetero_frontier_caps
      self.frontier_caps = normalize_hetero_frontier_caps(
          frontier_caps, dist_graph.etypes)
    else:
      if isinstance(frontier_caps, dict):
        raise ValueError('dict-form frontier_caps is hetero-only; pass '
                         'a per-hop list on homogeneous graphs')
      self.frontier_caps = tuple(frontier_caps)
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    # the stream position: batch keys are split(fold_in(key, count), P)
    # with count starting at 1 (_keys_for)
    self._call_count = 0
    self._dev = dist_graph.device_arrays(mesh)
    if with_weight:
      loc = mesh.local_shards
      if self.is_hetero:
        for et, g in dist_graph.sub.items():
          if g.weights is not None:
            self._dev[et]['wcum'] = _to(mesh, g.row_cumsum_stacked()[loc],
                                        torch.float32)
      elif dist_graph.weights is not None:
        self._dev['wcum'] = _to(mesh, dist_graph.row_cumsum_stacked()[loc],
                                torch.float32)

  def _weighted_for(self, etype=None) -> bool:
    if not self.with_weight:
      return False
    if self.is_hetero:
      return 'wcum' in self._dev[etype]
    return 'wcum' in self._dev

  def _sorted_loc_dev(self, etype=None):
    """The local shards' segment-sorted neighbour ids ``[L, E]`` (the
    negatives' membership table), uploaded once."""
    key = ('#sorted', etype)
    if key not in self._dev:
      g = self.graph.sub[etype] if etype is not None else self.graph
      self._dev[key] = _to(
          self.mesh, g.sorted_local_indices()[self.mesh.local_shards],
          torch.int32)
    return self._dev[key]

  def _keys_for(self, count):
    """Per-shard keys ``[P, 2]`` (host) of stream position ``count``:
    ``split(fold_in(base_key, count), P)``."""
    return trandom.split(trandom.fold_in(self._key, count),
                         self.graph.num_partitions)

  def _next_keys(self):
    self._call_count += 1
    return self._keys_for(self._call_count)

  def state_dict(self):
    """The base key and the stream position."""
    return {'key': [int(v) for v in self._key.tolist()],
            'call_count': self._call_count}

  def load_state_dict(self, state):
    if 'key' not in state:
      raise ValueError(
          f'checkpoint sampler state {sorted(state)} was written by a '
          'different sampler type; resuming would diverge')
    self._key = torch.as_tensor(
        np.asarray(state['key'], np.uint32).astype(np.int64))
    self._call_count = int(state.get('call_count', 0))

  def _capacities(self, b: int, with_frontier_caps: bool = True):
    """The per-hop frontier capacity plan (per shard). The subgraph path
    passes ``with_frontier_caps=False``: its legacy inducer has no clean
    truncation, so calibration must not clamp it."""
    from ..sampler.neighbor_sampler import capacity_plan
    return capacity_plan(
        b, list(self.num_neighbors), self.node_budget,
        self.frontier_caps if with_frontier_caps else None)

  def hop_caps(self, batch_cap: int) -> List[int]:
    return self._capacities(batch_cap)

  @property
  def clamped_exact(self) -> bool:
    """True when the exact engine runs under calibrated frontier_caps:
    batches then carry the on-device ``metadata['overflow']`` flag,
    summed over the mesh."""
    return self.frontier_caps is not None and self.dedup == 'merge'

  def uncapped_clone(self) -> 'DistNeighborSampler':
    """This sampler's arrays, mesh and PRNG base without frontier_caps:
    the full-capacity replay target of the overflow guard."""
    clone = copy.copy(self)
    clone.frontier_caps = None
    return clone

  def _node_cap(self, caps) -> int:
    if self.dedup == 'tree':
      from ..sampler.neighbor_sampler import tree_layout_from_caps
      return tree_layout_from_caps(caps, self.num_neighbors)[0][-1]
    return sum(caps)

  # ----------------------------------------------------- typed static plan

  def _etype_fanouts(self, et) -> List[int]:
    nn = self.num_neighbors
    return list(nn[et]) if isinstance(nn, dict) else list(nn)

  def _hetero_plan(self, seed_widths: Dict):
    """``(num_hops, hop_caps, node_caps)``: the static per-hop typed plan
    (JAX's ``_hetero_plan``), for seed sets of several types. Items of a
    hop run in sorted edge-type order; dict-form frontier_caps clamp each
    (hop, etype)'s new nodes, hop entries being ``(fcap, k, cap)``."""
    from ..sampler.calibrate import clamp_etype_cap
    g = self.graph
    etype_caps = self.frontier_caps if self.is_hetero else None
    etypes = sorted(tuple(et) for et in g.etypes)
    edge_dir = g.edge_dir
    num_hops = max(len(self._etype_fanouts(et)) for et in etypes)
    ntypes = g.ntypes
    frontier_cap = {t: 0 for t in ntypes}
    for t, w in seed_widths.items():
      frontier_cap[t] = w
    node_caps = dict(frontier_cap)
    hop_caps = []
    for hop in range(num_hops):
      adds = {t: 0 for t in ntypes}
      per_et = {}
      for et in etypes:
        fo = self._etype_fanouts(et)
        if hop >= len(fo) or fo[hop] == 0:
          continue
        key_t = et[0] if edge_dir == 'out' else et[2]
        res_t = et[2] if edge_dir == 'out' else et[0]
        fcap = frontier_cap.get(key_t, 0)
        if fcap == 0:
          continue
        if self.node_budget is not None:
          fcap = min(fcap, self.node_budget)
        cap = clamp_etype_cap(etype_caps, et, hop, fcap * fo[hop])
        per_et[et] = (fcap, fo[hop], cap)
        adds[res_t] += cap
      hop_caps.append(per_et)
      for t in ntypes:
        frontier_cap[t] = adds[t]
        node_caps[t] += adds[t]
    return num_hops, hop_caps, node_caps

  def _hetero_key_count(self) -> int:
    """Keys a typed batch splits its shard key into: ``max(1, hops *
    max(1, |edge types|))`` (JAX's ``_hetero_engine``); the engine uses
    the first one per (hop, edge type) item."""
    num_hops = max(len(self._etype_fanouts(et)) for et in self.graph.etypes)
    return max(1, num_hops * max(1, len(self.graph.etypes)))

  def _hetero_engine(self, garr, pbs, seed_arrays, hop_keys, plan):
    """The typed multi-hop engine over the local shards (JAX's
    ``_hetero_engine``): per (hop, edge type) item, the exchange hop
    (``_exchange_hop`` under the item's key) and the induce into the
    result type's per-shard state.

    Args:
      garr: ``{etype: local CSR arrays}`` (``DistHeteroGraph.
        device_arrays``).
      pbs: ``{ntype: partition book}``.
      seed_arrays: ordered ``{ntype: (seeds [L, w], mask [L, w])}``.
      hop_keys: ``[L, _hetero_key_count(), 2]`` keys on the seeds' device
        (a shard key's split; item j takes key j).
      plan: ``_hetero_plan``'s.

    Returns ``(res, inv_dict)``: the per-type results stacked ``[L, ...]``
    and the seed inverses per seed type."""
    from ..sampler.neighbor_sampler import _final_touch_map, _inducer_for
    g = self.graph
    mesh = self.mesh
    nloc = mesh.num_local
    ntypes = list(g.ntypes)
    edge_dir = g.edge_dir
    with_edge = self.with_edge
    num_hops, hop_caps, node_caps = plan
    dev = next(iter(seed_arrays.values()))[0].device
    init_seed, init_empty, induce = _inducer_for(self.dedup)
    offsets = {t: (seed_arrays[t][0].shape[1] if t in seed_arrays else 0)
               for t in ntypes}      # the positional layout (tree mode)
    states, frontier, inv_dict = {}, {}, {}
    for t in ntypes:
      if node_caps[t] == 0:
        continue
      if t in seed_arrays:
        s, m = seed_arrays[t]
        outs = [init_seed(s[l], m[l], capacity=node_caps[t])
                for l in range(nloc)]
        states[t] = [o[0] for o in outs]
        frontier[t] = (torch.stack([o[1] for o in outs]),
                       torch.arange(s.shape[1], dtype=torch.int32,
                                    device=dev).expand(nloc, -1),
                       torch.stack([o[2] for o in outs]))
        inv_dict[t] = torch.stack([o[3] for o in outs])
      else:
        states[t] = [init_empty(node_caps[t], device=dev)
                     for _ in range(nloc)]
    zeros = torch.zeros((nloc,), dtype=torch.int32, device=dev)
    rows, cols, edges, emasks = {}, {}, {}, {}
    nodes_per_hop = {t: [torch.stack([st.num_nodes for st in states[t]])
                         if t in states else zeros] for t in ntypes}
    edges_per_hop = {}
    clamped = self.is_hetero and self.frontier_caps is not None
    overflow = torch.zeros((nloc,), dtype=torch.bool, device=dev)
    ki = 0
    for hop in range(num_hops):
      new_parts = {t: [] for t in ntypes}
      items = list(hop_caps[hop].items())
      last_touch = (_final_touch_map(items, edge_dir)
                    if hop + 1 == num_hops else {})
      for j, (et, (fcap, k, ecap)) in enumerate(items):
        key_t = et[0] if edge_dir == 'out' else et[2]
        res_t = et[2] if edge_dir == 'out' else et[0]
        out_et = reverse_edge_type(et) if edge_dir == 'out' else et
        f, fidx, fmask = (v[:, :fcap] for v in frontier[key_t])
        nbrs, m, e = _exchange_hop(mesh, garr[et], pbs[key_t], f, fmask, k,
                                   hop_keys[:, ki], with_edge,
                                   self._weighted_for(et),
                                   bucket_frac=self.bucket_frac)
        ki += 1
        outs = []
        for l in range(nloc):
          states[res_t][l], iout = induce(
              states[res_t][l], fidx[l], nbrs[l], m[l], offsets[res_t],
              final=last_touch.get(res_t) == j,
              max_new=ecap if clamped else None)
          outs.append(iout)
        offsets[res_t] += ecap
        em = torch.stack([o['edge_mask'] for o in outs])
        rows.setdefault(out_et, []).append(
            torch.stack([o['cols'] for o in outs]))
        cols.setdefault(out_et, []).append(
            torch.stack([o['rows'] for o in outs]))
        emasks.setdefault(out_et, []).append(em)
        if with_edge:
          edges.setdefault(out_et, []).append(
              torch.where(em, e.reshape(nloc, -1), -1))
        edges_per_hop.setdefault(out_et, []).append(
            em.sum(1).to(torch.int32))
        if clamped and ecap < fcap * k:
          overflow = overflow | (torch.stack([o['num_new'] for o in outs])
                                 > ecap)
        new_parts[res_t].append(tuple(
            torch.stack([o[name][:ecap] for o in outs])
            for name in ('frontier', 'frontier_idx', 'frontier_mask')))
      for t in ntypes:
        parts = new_parts[t]
        if not parts:
          frontier[t] = (
              torch.zeros((nloc, 0), dtype=torch.int32, device=dev),
              torch.zeros((nloc, 0), dtype=torch.int32, device=dev),
              torch.zeros((nloc, 0), dtype=torch.bool, device=dev))
          nodes_per_hop[t].append(zeros)
          continue
        fr = torch.cat([p[0] for p in parts], 1)
        fi = torch.cat([p[1] for p in parts], 1)
        fm = torch.cat([p[2] for p in parts], 1)
        if self.dedup == 'merge' and len(parts) > 1:
          # cross-part compaction, as the local typed engine: a stable
          # valid-first sort per shard
          order = torch.argsort((~fm).to(torch.int32), dim=1, stable=True)
          fr, fi, fm = (fr.gather(1, order), fi.gather(1, order),
                        fm.gather(1, order))
        frontier[t] = (fr, fi, fm)
        nodes_per_hop[t].append(fm.sum(1).to(torch.int32))
    # one verdict on every shard
    overflow = mesh.psum(overflow.to(torch.int32)) > 0
    res = dict(
        overflow=overflow,
        node={t: torch.stack([st.nodes for st in v])
              for t, v in states.items()},
        num_nodes={t: torch.stack([st.num_nodes for st in v])
                   for t, v in states.items()},
        row={et: torch.cat(v, 1) for et, v in rows.items()},
        col={et: torch.cat(v, 1) for et, v in cols.items()},
        edge_mask={et: torch.cat(v, 1) for et, v in emasks.items()},
        num_sampled_nodes={t: torch.stack(v, 1)
                           for t, v in nodes_per_hop.items()},
        num_sampled_edges={et: torch.stack(v, 1)
                           for et, v in edges_per_hop.items()})
    if with_edge:
      res['edge'] = {et: torch.cat(v, 1) for et, v in edges.items()}
    return res, inv_dict

  def _hop_keys_dev(self, keys, n: int):
    """``split(keys, n)`` of ``[L, 2]`` host keys, on the mesh's device."""
    hk = trandom.split(keys, n)
    if self.mesh.device.type == 'cuda':
      hk = trandom.to_device(hk, self.mesh.device)
    return hk

  # ------------------------------------------------------------ public API

  def _shard_blocks(self, raw, seed_mask):
    """Seeds ``[P, B]`` (or ``[P * B]``) and their mask as the mesh's
    local ``[L, B]`` rows on its device."""
    mesh = self.mesh
    p = self.graph.num_partitions
    seeds = torch.as_tensor(np.asarray(raw) if not torch.is_tensor(raw)
                            else raw).to(torch.int32)
    if seeds.dim() == 1:
      assert seeds.shape[0] % p == 0, 'flat seeds must split evenly'
      seeds = seeds.reshape(p, -1)
    smask = (torch.ones(seeds.shape, dtype=torch.bool) if seed_mask is None
             else torch.as_tensor(np.asarray(seed_mask)
                                  if not torch.is_tensor(seed_mask)
                                  else seed_mask).reshape(seeds.shape))
    seeds = _to(mesh, mesh.local_rows(seeds), torch.int32) \
        if seeds.device.type == 'cpu' else mesh.local_rows(seeds)
    smask = _to(mesh, mesh.local_rows(smask), torch.bool) \
        if smask.device.type == 'cpu' else mesh.local_rows(smask)
    return seeds, smask

  def _local_keys(self, keys):
    return self.mesh.local_rows(
        torch.as_tensor(keys, dtype=torch.int64).cpu())

  def sample_from_nodes(self, inputs, seed_mask=None, keys=None,
                        **kwargs) -> SamplerOutput:
    """Per-shard batches from seeds ``[P, B]`` (or ``[P*B]``, split
    evenly); a process of a process-group mesh samples its own rows.

    Returns a ``SamplerOutput`` (a ``HeteroSamplerOutput`` on a typed
    graph, whose seeds are ``(ntype, ids)`` or a typed
    ``NodeSamplerInput``) whose tensors carry the leading local shard
    axis ``[L, ...]``. ``seed_mask`` marks padding seeds False (they
    produce no nodes or edges). ``keys``: explicit per-shard keys ``[P,
    2]`` (default: the sampler's stream); the overflow guard replays a
    truncated batch at full capacities with the same keys. As in JAX, a
    typed batch always takes the stream's next keys."""
    input_ntype = None
    if isinstance(inputs, NodeSamplerInput):
      input_ntype, raw = inputs.input_type, inputs.node
    elif isinstance(inputs, tuple) and len(inputs) == 2 and \
        isinstance(inputs[0], str):
      input_ntype, raw = inputs
    else:
      raw = inputs
    seeds, smask = self._shard_blocks(raw, seed_mask)
    b = seeds.shape[1]
    if self.is_hetero:
      assert input_ntype is not None, \
          'hetero distributed sampling requires an input node type'
      if input_ntype not in self.graph.ntypes:
        raise ValueError(f'unknown input node type {input_ntype!r}; '
                         f'graph has {self.graph.ntypes}')
      return self._hetero_sample_from_nodes(input_ntype, seeds, smask)
    mesh = self.mesh
    keys = self._local_keys(keys if keys is not None else self._next_keys())
    caps = self._capacities(b)
    res = _homo_hop_loop(mesh, self._dev, self._dev['node_pb'], seeds,
                         smask, keys, tuple(self.num_neighbors), caps,
                         self._node_cap(caps), self.with_edge,
                         self._weighted_for(), dedup=self.dedup,
                         bucket_frac=self.bucket_frac)
    return SamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res.get('edge'), edge_mask=res['edge_mask'],
        batch=seeds, batch_size=b,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        metadata={'seed_inverse': res['seed_inverse'], 'seed_mask': smask,
                  'overflow': res['overflow']})

  def _hetero_sample_from_nodes(self, input_ntype, seeds, smask):
    """Typed seeds of ``input_ntype`` through the typed engine under the
    stream's next keys."""
    b = seeds.shape[1]
    plan = self._hetero_plan({input_ntype: b})
    keys = self._local_keys(self._next_keys())
    res, inv_dict = self._hetero_engine(
        self._dev, self._dev['#pb'], {input_ntype: (seeds, smask)},
        self._hop_keys_dev(keys, self._hetero_key_count()), plan)
    return HeteroSamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res.get('edge'), edge_mask=res['edge_mask'],
        batch={input_ntype: seeds}, batch_size=b,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        input_type=input_ntype,
        metadata={'seed_inverse': inv_dict[input_ntype],
                  'seed_mask': smask, 'overflow': res['overflow']})

  # ------------------------------------------------------------------ link

  def _local_negatives(self, garr, sorted_loc, num_dst, num_neg, kneg):
    """Per local shard, ``ops.random_negative_sample_local`` under its
    negative key: ``(src, dst, valid)`` stacked ``[L, num_neg]``."""
    dev = self.mesh.device
    if dev.type == 'cuda':
      kneg = trandom.to_device(kneg.contiguous(), dev)
    outs = [ops.random_negative_sample_local(
        garr['row_ids'][l], garr['indptr'][l], sorted_loc[l], num_dst,
        num_neg, kneg[l], strict=self.neg_strict)
        for l in range(self.mesh.num_local)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

  def sample_from_edges(self, inputs: EdgeSamplerInput, seed_mask=None,
                        keys=None, **kwargs):
    """Distributed link sampling over seed edges ``[P, B]`` per shard
    (JAX's ``sample_from_edges``).

    Per shard the key splits into ``kneg, kloop``: ``kneg`` draws
    shard-local negatives against the shard's own CSR
    (``ops.random_negative_sample_local``: one launch of the negative
    kernel's local entry on a card), ``kloop`` samples the union of the
    positives' endpoints and the negatives. Metadata: ``edge_label_index``
    and ``edge_label`` (none, binary) or ``src_index`` /
    ``dst_pos_index`` / ``dst_neg_index`` (triplet), per shard, through
    ``seed_inverse``. A typed graph takes seed edges of
    ``inputs.input_type`` (the stream's next keys, as in JAX). No host
    sync at ``bucket_frac=None``."""
    mesh = self.mesh
    p = self.graph.num_partitions
    rows = np.asarray(inputs.row)
    cols = np.asarray(inputs.col)
    if rows.ndim == 1:
      assert rows.shape[0] % p == 0, 'flat seed edges must split evenly'
      rows = rows.reshape(p, -1)
      cols = cols.reshape(p, -1)
    b = rows.shape[1]
    rows_d, smask = self._shard_blocks(rows, seed_mask)
    cols_d, _ = self._shard_blocks(cols, None)
    neg = inputs.neg_sampling
    mode = 'none' if neg is None else neg.mode
    num_neg = 0 if neg is None else neg.num_negatives(b)
    if self.is_hetero:
      etype = inputs.input_type
      assert etype is not None, 'hetero link sampling requires input_type'
      out, md = self._hetero_link(tuple(etype), rows_d, cols_d, smask, b,
                                  num_neg, mode)
    else:
      out, md = self._homo_link(rows_d, cols_d, smask, b, num_neg, mode,
                                keys)
    if mode in ('none', 'binary'):
      if inputs.label is not None:
        lab = np.asarray(inputs.label).reshape(p, b)
        label = _to(mesh, mesh.local_rows(lab), _jax_dtype(lab))
      else:
        label = torch.ones((mesh.num_local, b), dtype=torch.int32,
                           device=mesh.device)
      if mode == 'binary':
        label = torch.cat([label, torch.zeros((mesh.num_local, num_neg),
                                              dtype=label.dtype,
                                              device=label.device)], 1)
      out.metadata['edge_label'] = label
    out.metadata.update(md)
    return out

  def _link_metadata(self, inv_src, inv_dst, b, num_neg, mode):
    """The supervision metadata from the endpoints' seed inverses."""
    if mode == 'none':
      return {'edge_label_index': torch.stack([inv_src[:, :b],
                                               inv_dst[:, :b]], 1)}
    if mode == 'binary':
      return {'edge_label_index': torch.stack(
          [inv_src[:, :b + num_neg], inv_dst[:, :b + num_neg]], 1)}
    return {'src_index': inv_src[:, :b], 'dst_pos_index': inv_dst[:, :b],
            'dst_neg_index': inv_dst[:, b:b + num_neg]}

  def _homo_link(self, rows, cols, smask, b, num_neg, mode, keys):
    """The homogeneous link batch (JAX's ``_build_link_fn``)."""
    mesh = self.mesh
    d = self._dev
    keys = self._local_keys(keys if keys is not None else self._next_keys())
    kk = trandom.split(keys)                              # [L, 2, 2]
    kneg, kloop = kk[:, 0], kk[:, 1]
    if mode == 'none':
      seeds = torch.cat([rows, cols], 1)
      seed_mask = torch.cat([smask, smask], 1)
    else:
      nr, nc, nvalid = self._local_negatives(
          d, self._sorted_loc_dev(), self.graph.num_nodes, num_neg, kneg)
      # the CSR's key side against (src, dst): flip for a CSC ('in')
      neg_src, neg_dst = ((nr, nc) if self.graph.edge_dir == 'out'
                          else (nc, nr))
      if mode == 'binary':
        seeds = torch.cat([rows, cols, neg_src, neg_dst], 1)
        seed_mask = torch.cat([smask, smask, nvalid, nvalid], 1)
      else:
        seeds = torch.cat([rows, cols, neg_dst], 1)
        seed_mask = torch.cat([smask, smask, nvalid], 1)
    caps = self._capacities(seeds.shape[1])
    res = _homo_hop_loop(mesh, d, d['node_pb'], seeds, seed_mask, kloop,
                         tuple(self.num_neighbors), caps,
                         self._node_cap(caps), self.with_edge,
                         self._weighted_for(), dedup=self.dedup,
                         bucket_frac=self.bucket_frac)
    inv = res['seed_inverse']
    if mode == 'binary':
      inv_src = torch.cat([inv[:, :b], inv[:, 2 * b:2 * b + num_neg]], 1)
      inv_dst = torch.cat([inv[:, b:2 * b],
                           inv[:, 2 * b + num_neg:2 * b + 2 * num_neg]], 1)
    else:
      inv_src, inv_dst = inv[:, :b], inv[:, b:]
    out = SamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res.get('edge'), edge_mask=res['edge_mask'],
        batch=torch.stack([rows, cols], 1), batch_size=b,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'],
        metadata={'seed_inverse': inv, 'seed_mask': smask,
                  'overflow': res['overflow']})
    return out, self._link_metadata(inv_src, inv_dst, b, num_neg, mode)

  def _hetero_link(self, etype, rows, cols, smask, b, num_neg, mode):
    """The typed link batch (JAX's ``_build_hetero_link_fn``): negatives
    against the seed edge type's local CSR, each endpoint type's seeds
    into its node type (one seed set when both are one type)."""
    g = self.graph
    src_t, _, dst_t = etype
    edge_dir = g.edge_dir
    # the candidates drawn on the CSR's column side belong to the
    # non-key endpoint type
    num_other = g.num_nodes(dst_t if edge_dir == 'out' else src_t)
    if mode == 'binary':
      ws, wd = b + num_neg, b + num_neg
    elif mode == 'triplet':
      ws, wd = b, b + num_neg
    else:
      ws, wd = b, b
    seed_widths = ({src_t: ws + wd} if src_t == dst_t
                   else {src_t: ws, dst_t: wd})
    plan = self._hetero_plan(seed_widths)
    keys = self._local_keys(self._next_keys())
    kk = trandom.split(keys)
    kneg, kloop = kk[:, 0], kk[:, 1]
    if mode == 'none':
      src_seeds, src_m, dst_seeds, dst_m = rows, smask, cols, smask
    else:
      nr, nc, nvalid = self._local_negatives(
          self._dev[etype], self._sorted_loc_dev(etype), num_other, num_neg,
          kneg)
      neg_src, neg_dst = (nr, nc) if edge_dir == 'out' else (nc, nr)
      if mode == 'binary':
        src_seeds = torch.cat([rows, neg_src], 1)
        src_m = torch.cat([smask, nvalid], 1)
      else:
        src_seeds, src_m = rows, smask
      dst_seeds = torch.cat([cols, neg_dst], 1)
      dst_m = torch.cat([smask, nvalid], 1)
    if src_t == dst_t:
      seed_arrays = {src_t: (torch.cat([src_seeds, dst_seeds], 1),
                             torch.cat([src_m, dst_m], 1))}
    else:
      seed_arrays = {src_t: (src_seeds, src_m), dst_t: (dst_seeds, dst_m)}
    res, inv_dict = self._hetero_engine(
        self._dev, self._dev['#pb'], seed_arrays,
        self._hop_keys_dev(kloop, self._hetero_key_count()), plan)
    if src_t == dst_t:
      inv = inv_dict[src_t]
      inv_src, inv_dst = inv[:, :ws], inv[:, ws:ws + wd]
    else:
      inv_src, inv_dst = inv_dict[src_t], inv_dict[dst_t]
    out = HeteroSamplerOutput(
        node=res['node'], num_nodes=res['num_nodes'], row=res['row'],
        col=res['col'], edge=res.get('edge'), edge_mask=res['edge_mask'],
        batch=None, batch_size=b,
        num_sampled_nodes=res['num_sampled_nodes'],
        num_sampled_edges=res['num_sampled_edges'], input_type=etype,
        metadata={'seed_mask': smask, 'overflow': res['overflow']})
    return out, self._link_metadata(inv_src, inv_dst, b, num_neg, mode)

  # -------------------------------------------------------------- subgraph

  def subgraph(self, inputs, seed_mask=None,
               max_degree: Optional[int] = None, **kwargs):
    """The induced subgraph of per-shard seed blocks ``[P, B]`` (JAX's
    ``subgraph``): an optional hop expansion, the deduped node set, an
    ``all_gather`` of every shard's node keys, each shard's extraction
    against every gathered set (``ops.node_subgraph_local``), and an
    ``all_to_all`` of the results back to the set's shard, with the
    seeds' ``mapping`` into the node set. ``max_degree`` (default: the
    graph's, read once on the host) caps the scanned columns of a row.
    A one-process mesh holds ``[P, P, node_cap * max_degree]`` results.
    Typed graphs are refused, as in JAX."""
    if self.is_hetero:
      # graftlint: allow[hetero-gate] reference-parity, not unmigrated
      raise NotImplementedError(
          'hetero distributed subgraph sampling (reference parity: '
          'dist_neighbor_sampler.py:505 raises NotImplementedError)')
    raw = inputs.node if isinstance(inputs, NodeSamplerInput) else inputs
    seeds, smask = self._shard_blocks(raw, seed_mask)
    b = seeds.shape[1]
    mesh = self.mesh
    nparts = self.graph.num_partitions
    if max_degree is None:
      max_degree = self._global_max_degree()
    caps = self._capacities(b, with_frontier_caps=False)
    node_cap = sum(caps)
    buf_elems = nparts * node_cap * max_degree
    if buf_elems > (1 << 25):
      warnings.warn(
          f'distributed subgraph buffers are [P={nparts} x node_cap='
          f'{node_cap} x max_degree={max_degree}] = {buf_elems / 1e6:.0f}M '
          'elements per shard; on power-law graphs pass an explicit '
          'max_degree cap (edges beyond the cap per row are dropped) to '
          'bound memory', stacklevel=2)
    keys = self._local_keys(self._next_keys())
    d = self._dev
    fanouts = tuple(self.num_neighbors)
    if fanouts:
      node_buf, nvalid = _subgraph_hop_loop(
          mesh, d, d['node_pb'], seeds, smask, keys, fanouts, caps,
          node_cap, self._weighted_for(), self.bucket_frac)
    else:
      node_buf, nvalid = seeds, smask
    nloc = mesh.num_local
    dev = seeds.device
    sets = [ops.masked_unique(node_buf[l], nvalid[l], size=node_cap)
            for l in range(nloc)]
    nodes = torch.stack([s[0] for s in sets])
    num_nodes = torch.stack([s[1] for s in sets]).to(torch.int32)
    big = torch.iinfo(torch.int32).max
    arange = torch.arange(node_cap, device=dev)
    nkeys = torch.where(arange[None, :] < num_nodes[:, None], nodes, big)
    all_keys = mesh.all_gather(nkeys)                     # [L, P, cap]
    subs = [[ops.node_subgraph_local(d['row_ids'][l], d['indptr'][l],
                                     d['indices'][l], all_keys[l, q],
                                     max_degree) for q in range(nparts)]
            for l in range(nloc)]

    def back(name):
      return mesh.all_to_all(torch.stack([
          torch.stack([s[name] for s in row]) for row in subs])
      ).reshape(nloc, -1)

    row, col, em = back('rows'), back('cols'), back('edge_mask')
    edge = None
    if self.with_edge:
      eids = d['eids']
      send = []
      for l, srow in enumerate(subs):
        if eids.shape[1] == 0:
          send.append(torch.full((nparts, srow[0]['epos'].shape[0]), -1,
                                 dtype=torch.int64, device=dev))
        else:
          send.append(torch.stack([torch.where(
              s['edge_mask'], eids[l][s['epos']], -1) for s in srow]))
      edge = mesh.all_to_all(torch.stack(send)).reshape(nloc, -1)
    spos = torch.stack([torch.searchsorted(nkeys[l], seeds[l])
                        for l in range(nloc)]).clamp(0, node_cap - 1)
    mapping = torch.where(smask & (nkeys.gather(1, spos) == seeds),
                          spos.to(torch.int32), -1)
    return SamplerOutput(
        node=nodes, num_nodes=num_nodes, row=row, col=col, edge=edge,
        edge_mask=em, batch=seeds, batch_size=b, num_sampled_nodes=None,
        num_sampled_edges=None,
        metadata={'mapping': mapping, 'seed_mask': smask})

  def _global_max_degree(self) -> int:
    if not hasattr(self, '_max_deg'):
      self._max_deg = max(
          1, int(np.max(np.diff(self.graph.indptr, axis=1))))
    return self._max_deg

  # --------------------------------------------------------------- collate

  def collate(self, out, node_labels=None, label_cap=None):
    """Features (the sharded ``DistFeature`` lookup) and labels of a
    batch. Labels are partitioned like features: each shard holds its
    owned nodes' labels as a 1-wide store and the gather takes the same
    exchange. ``label_cap``: labels of the first ``label_cap`` slots
    only (the seed block leads each shard's buffer); on a typed batch
    then only the seed type's."""
    if isinstance(out, HeteroSamplerOutput):
      x = y = None
      if self.collect_features and self.dist_feature is not None:
        x = {t: self.dist_feature[t].get(out.node[t])
             for t in out.node if t in self.dist_feature}
      if node_labels is not None:
        y = {}
        for t in out.node:
          if t not in node_labels:
            continue
          if label_cap is not None and t != out.input_type:
            continue
          buf = (out.node[t] if label_cap is None
                 else out.node[t][:, :label_cap])
          y[t] = self._label_dist(node_labels[t], t).get(buf)[..., 0]
      return x, y
    x = None
    if self.collect_features:
      x = self.dist_feature.get(out.node)
    y = None
    if node_labels is not None:
      buf = out.node if label_cap is None else out.node[:, :label_cap]
      y = self._label_dist(node_labels).get(buf)[..., 0]
    return x, y

  def label_stores(self):
    """The sharded label stores built by ``_label_dist``."""
    if hasattr(self, '_labels_cache'):
      for _, store in self._labels_cache.values():
        yield store

  def _label_dist(self, labels, key=None):
    """The sharded label store (of node type ``key`` on a typed graph),
    built once per label array (keyed by identity), exchanging at the
    sampler's ``bucket_frac``."""
    if not hasattr(self, '_labels_cache'):
      self._labels_cache = {}
    hit = self._labels_cache.get(key)
    if hit is None or hit[0] != id(labels):
      lab = np.asarray(labels).reshape(-1)
      if lab.dtype == np.int64:
        lab = lab.astype(np.int32)
      elif lab.dtype == np.float64:
        lab = lab.astype(np.float32)
      pb = self.graph.node_pb[key] if self.is_hetero else self.graph.node_pb
      blocks = []
      for p in range(self.graph.num_partitions):
        ids = np.nonzero(pb == p)[0].astype(np.int64)
        blocks.append((ids, lab[ids][:, None]))
      # the sampler's bucket_frac (JAX's label store keeps the default
      # 2.0): the rows never depend on it, and bucket_frac=None then
      # reads no verdict on the host at all
      hit = (id(labels), DistFeature(self.graph.num_partitions, blocks, pb,
                                     mesh=self.mesh,
                                     bucket_frac=self.bucket_frac))
      self._labels_cache[key] = hit
    return hit[1]
