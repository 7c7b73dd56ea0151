"""Distributed node sampling over a sharded graph.

Counterpart of the homogeneous node path of
``graphlearn_tpu/distributed/dist_neighbor_sampler.py``. JAX compiles
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
Link, subgraph and typed sampling come with the next slice.
"""
import copy
from typing import List, Optional, Union

import numpy as np
import torch

from .. import ops
from .. import random as trandom
from ..ops.route import exchange_capacity
from ..sampler import NodeSamplerInput, SamplerOutput
from .dist_context import ShardMesh
from .dist_feature import DistFeature, exchange_width
from .dist_graph import DistGraph, DistHeteroGraph, _to

_NEXT_SLICE = ('comes with the next distributed slice (the dist link, '
               'subgraph and typed samplers)')


def _local_sample(garr, l, flat, fm, k, key, weighted: bool):
  """One shard's fanout sample over its local CSR (local index ``l``)."""
  if weighted:
    return ops.weighted_sample_local(
        garr['row_ids'][l], garr['indptr'][l], garr['indices'][l],
        garr['wcum'][l], flat, fm, k, key)
  return ops.uniform_sample_local(
      garr['row_ids'][l], garr['indptr'][l], garr['indices'][l], flat, fm,
      k, key)


def _exchange_hop(mesh: ShardMesh, garr, pb, frontier, fmask, k, keys,
                  with_edge: bool, weighted: bool = False,
                  bucket_frac=2.0):
  """One cross-shard hop of the ``[L, bf]`` frontiers: route by the
  partition book, exchange the requests, sample them on their owners
  (``keys[l]``: shard l's hop key), exchange the responses, un-permute.
  Returns ``(nbrs, mask, edges or None)``, each ``[L, bf, k]``.

  With ``bucket_frac=None`` every bucket is the full frontier width and
  can never overflow. With a fraction the buckets are ``round8(frac *
  bf / P)`` wide, and the hop falls back to the full width when any
  shard's buckets overflow (the one counted host read)."""
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
      eids = garr['eids'][l]
      if eids.shape[0] == 0:
        e = torch.full(m.shape, -1, dtype=torch.int64, device=m.device)
      else:
        e = torch.where(m, eids[torch.where(m, epos, 0).long()], -1)
      edges.append(e.reshape(nparts, cap, k))
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


class DistNeighborSampler:
  """Per-shard batches from per-shard seed blocks over a ``DistGraph``.

  Args:
    dist_graph: ``DistGraph`` (a ``DistHeteroGraph`` is accepted, and
      its sampling comes with the next slice).
    num_neighbors: per-hop fanouts.
    mesh: a ``ShardMesh`` of ``num_partitions`` shards.
    dist_feature: optional ``DistFeature`` for ``collate``.
    with_edge: emit global edge ids.
    with_weight: edge-weight-biased sampling (over the shards' row CDFs).
    seed: PRNG seed.
    node_budget / frontier_caps: the capacity clamps of the single-device
      sampler (``frontier_caps`` for the exact modes only).
    dedup: 'tree' ('none') or 'sort' / 'map' / 'merge' (exact).
    bucket_frac: exchange slack over the mean per-destination load
      (None: the full width).
    neg_strict: kept for the link sampler of the next slice.
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
            'sampler.calibrate.estimate_frontier_caps (batch_size = the '
            "PER-SHARD seed width); 'auto' exists on the local loaders "
            'only')
      if self.dedup == 'tree':
        raise ValueError('frontier_caps requires an exact-dedup mode '
                         "('sort'/'map'/'merge'); tree frontiers are "
                         'positional, use node_budget there')
      if self.is_hetero:
        raise NotImplementedError('typed frontier_caps ' + _NEXT_SLICE)
      if isinstance(frontier_caps, dict):
        raise ValueError('dict-form frontier_caps is hetero-only; pass '
                         'a per-hop list on homogeneous graphs')
      self.frontier_caps = tuple(frontier_caps)
    else:
      self.frontier_caps = None
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    # the stream position: batch keys are split(fold_in(key, count), P)
    # with count starting at 1 (_keys_for)
    self._call_count = 0
    self._dev = dist_graph.device_arrays(mesh)
    if with_weight and not self.is_hetero and \
        dist_graph.weights is not None:
      self._dev['wcum'] = _to(mesh, dist_graph.row_cumsum_stacked()[
          mesh.local_shards], torch.float32)

  def _weighted_for(self) -> bool:
    return self.with_weight and 'wcum' in self._dev

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
    """The per-hop frontier capacity plan (per shard)."""
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

  def sample_from_nodes(self, inputs, seed_mask=None, keys=None,
                        **kwargs) -> SamplerOutput:
    """Per-shard batches from seeds ``[P, B]`` (or ``[P*B]``, split
    evenly); a process of a process-group mesh samples its own rows.

    Returns a ``SamplerOutput`` whose tensors carry the leading local
    shard axis ``[L, ...]``. ``seed_mask`` marks padding seeds False
    (they produce no nodes or edges). ``keys``: explicit per-shard keys
    ``[P, 2]`` (default: the sampler's stream); the overflow guard
    replays a truncated batch at full capacities with the same keys."""
    if isinstance(inputs, NodeSamplerInput):
      raw = inputs.node
      if inputs.input_type is not None or self.is_hetero:
        raise NotImplementedError('typed distributed sampling ' +
                                  _NEXT_SLICE)
    elif isinstance(inputs, tuple) and len(inputs) == 2 and \
        isinstance(inputs[0], str):
      raise NotImplementedError('typed distributed sampling ' + _NEXT_SLICE)
    else:
      raw = inputs
    if self.is_hetero:
      raise NotImplementedError('typed distributed sampling ' + _NEXT_SLICE)
    mesh = self.mesh
    p = self.graph.num_partitions
    seeds = torch.as_tensor(np.asarray(raw) if not torch.is_tensor(raw)
                            else raw).to(torch.int32)
    if seeds.dim() == 1:
      assert seeds.shape[0] % p == 0, 'flat seeds must split evenly'
      seeds = seeds.reshape(p, -1)
    b = seeds.shape[1]
    smask = (torch.ones(seeds.shape, dtype=torch.bool) if seed_mask is None
             else torch.as_tensor(np.asarray(seed_mask)
                                  if not torch.is_tensor(seed_mask)
                                  else seed_mask).reshape(seeds.shape))
    seeds = _to(mesh, mesh.local_rows(seeds), torch.int32) \
        if seeds.device.type == 'cpu' else mesh.local_rows(seeds)
    smask = _to(mesh, mesh.local_rows(smask), torch.bool) \
        if smask.device.type == 'cpu' else mesh.local_rows(smask)
    keys = keys if keys is not None else self._next_keys()
    keys = mesh.local_rows(torch.as_tensor(keys, dtype=torch.int64).cpu())
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

  def sample_from_edges(self, inputs, seed_mask=None, keys=None, **kwargs):
    raise NotImplementedError('distributed link sampling ' + _NEXT_SLICE)

  def subgraph(self, inputs, seed_mask=None,
               max_degree: Optional[int] = None, **kwargs):
    raise NotImplementedError('distributed subgraph sampling ' + _NEXT_SLICE)

  def collate(self, out, node_labels=None, label_cap=None):
    """Features (the sharded ``DistFeature`` lookup) and labels of a
    batch. Labels are partitioned like features: each shard holds its
    owned nodes' labels as a 1-wide store and the gather takes the same
    exchange. ``label_cap``: labels of the first ``label_cap`` slots
    only (the seed block leads each shard's buffer)."""
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
    """The sharded label store, built once per label array (keyed by
    identity), exchanging at the sampler's ``bucket_frac``."""
    if not hasattr(self, '_labels_cache'):
      self._labels_cache = {}
    hit = self._labels_cache.get(key)
    if hit is None or hit[0] != id(labels):
      lab = np.asarray(labels).reshape(-1)
      if lab.dtype == np.int64:
        lab = lab.astype(np.int32)
      elif lab.dtype == np.float64:
        lab = lab.astype(np.float32)
      pb = self.graph.node_pb
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
