"""The distributed random partitioner and its shared partition book.

Counterpart of ``graphlearn_tpu/distributed/dist_random_partitioner.py``:
every rank computes the same node book from a seed
(:func:`shared_node_pb`), so none is broadcast, and
:class:`DistRandomPartitioner` writes each rank's slice of the graph and
features into the partitions through the shared filesystem, host numpy
only, with the phases sequenced by the RPC layer's ``Barrier``. Its
files equal JAX's array for array.
"""
import json
import os
import shutil
from typing import Dict, Optional, Union

import numpy as np

from ..partition.base import _type_str
from .rpc import Barrier, RpcClient, RpcServer


def shared_node_pb(num_nodes: int, num_parts: int, seed: int) -> np.ndarray:
  """A seeded shuffle of the ``num_nodes`` ids dealt in equal contiguous
  shares: ``[num_nodes]`` int32 owning partitions, equal on every rank."""
  rng = np.random.default_rng(seed)
  perm = rng.permutation(num_nodes)
  pb = np.empty(num_nodes, dtype=np.int32)
  share = (num_nodes + num_parts - 1) // num_parts
  for p in range(num_parts):
    pb[perm[p * share:(p + 1) * share]] = p
  return pb


class DistRandomPartitioner:
  """Parallel (multi-rank) random partitioning, homogeneous and typed.

  The node book is derived deterministically from the shared seed
  (:func:`shared_node_pb`), so the ranks need not agree on it over the
  wire; the payloads go through the shared filesystem (each rank spools
  its chunks into the target partition's directory), and a TCP
  ``rpc.Barrier`` hosted by rank 0 sequences the phases. The output
  layout is ``partition/base.py``'s, so ``DistDataset.load`` reads it.

  Args:
    output_dir: shared filesystem target.
    num_nodes: global node count (dict per ntype for hetero).
    edge_index / edge_ids / node_feat / node_feat_ids: THIS RANK's slice
      (dicts keyed by edge/node type for hetero).
    num_parts: partition count (defaults to world_size).
    rank / world_size: this rank's coordinates.
    master_addr/master_port: rank-0 barrier endpoint (None => single rank).
  """

  def __init__(self, output_dir: str,
               num_nodes: Union[int, Dict], edge_index,
               edge_ids=None, node_feat=None, node_feat_ids=None,
               num_parts: Optional[int] = None, rank: int = 0,
               world_size: int = 1, master_addr: str = '127.0.0.1',
               master_port: Optional[int] = None, seed: int = 0,
               edge_assign_strategy: str = 'by_src'):
    self.output_dir = output_dir
    self.is_hetero = isinstance(edge_index, dict)
    self.num_nodes = num_nodes
    self.edge_index = edge_index
    self.edge_ids = edge_ids
    self.node_feat = node_feat
    self.node_feat_ids = node_feat_ids
    self.num_parts = num_parts or world_size
    self.rank = rank
    self.world_size = world_size
    self.master_addr = master_addr
    self.master_port = master_port
    self.seed = seed
    self.edge_assign_strategy = edge_assign_strategy
    self._server = None
    self._client = None
    self._phase = 0

  # -- barrier plumbing ----------------------------------------------------

  def _init_comm(self):
    if self.world_size <= 1:
      return
    if self.rank == 0:
      barrier = Barrier(self.world_size)
      self._server = RpcServer(
          self.master_addr, self.master_port or 0,
          handlers={'partition_barrier': barrier.arrive})
      self.master_port = self._server.port
    self._client = RpcClient()
    self._client.add_target(0, self.master_addr, self.master_port)

  def _barrier(self):
    if self._client is None:
      return
    # rank 0 binds its barrier server concurrently with the other ranks'
    # first arrival — retry refused connections instead of dying (which
    # would strand rank 0 in a 180 s barrier timeout). The phase counter
    # makes retries idempotent across generations (rpc.Barrier.arrive),
    # so the arrival can ride the standard backoff policy.
    from .resilience import RetryPolicy
    phase = self._phase
    self._phase += 1
    # flat 0.2s polls: the attempt budget must outlast the 60s deadline
    # (exponential growth would exhaust the backoff sum long before the
    # window rank 0 historically got to bind its barrier server)
    policy = RetryPolicy(max_attempts=400, base_delay=0.2, max_delay=0.2,
                         multiplier=1.0, jitter=0.0, total_deadline=60.0)
    self._client.request_sync(0, 'partition_barrier', self.rank,
                              phase=phase, idempotent=True,
                              retry_policy=policy)

  # -- typed views ---------------------------------------------------------

  def _ntypes(self):
    if not self.is_hetero:
      return [None]
    types = {t for et in self.edge_index for t in (et[0], et[2])}
    if isinstance(self.num_nodes, dict):
      types |= set(self.num_nodes)      # featured-but-edgeless node types
    if isinstance(self.node_feat, dict):
      types |= set(self.node_feat)
    return sorted(types)

  def _etypes(self):
    return list(self.edge_index) if self.is_hetero else [None]

  def _node_pb_for(self, ntype):
    """Every rank derives the same per-type book from (seed, type)."""
    n = (self.num_nodes[ntype] if self.is_hetero else self.num_nodes)
    off = 0 if ntype is None else self._ntypes().index(ntype)
    return shared_node_pb(n, self.num_parts, self.seed + off)

  def _sel(self, maybe_dict, key):
    if maybe_dict is None:
      return None
    return maybe_dict.get(key) if isinstance(maybe_dict, dict) \
        else (maybe_dict if key is None else None)

  def _tag(self, type_):
    return '' if type_ is None else '_' + _type_str(type_).replace(
        os.sep, '-')

  # -- partitioning --------------------------------------------------------

  def partition(self) -> str:
    self._init_comm()
    ntypes, etypes = self._ntypes(), self._etypes()
    node_pbs = {nt: self._node_pb_for(nt) for nt in ntypes}

    # phase 1: every rank spools its slice's chunks into target partitions
    for et in etypes:
      ei = np.asarray(self.edge_index[et] if self.is_hetero
                      else self.edge_index)
      rows, cols = ei[0].reshape(-1), ei[1].reshape(-1)
      eids = self._sel(self.edge_ids, et)
      if eids is None and self.world_size > 1:
        raise ValueError(
            'multi-rank partitioning requires explicit global edge_ids '
            'per slice — a per-rank arange default would produce '
            'duplicate edge ids across ranks')
      eids = (np.asarray(eids) if eids is not None
              else np.arange(rows.shape[0], dtype=np.int64))
      if self.is_hetero:
        key_pb = node_pbs[et[0] if self.edge_assign_strategy == 'by_src'
                          else et[2]]
      else:
        key_pb = node_pbs[None]
      key = rows if self.edge_assign_strategy == 'by_src' else cols
      edge_owner = key_pb[key]
      for p in range(self.num_parts):
        spool = os.path.join(self.output_dir, f'part{p}', '_spool')
        os.makedirs(spool, exist_ok=True)
        m = edge_owner == p
        np.savez(os.path.join(
            spool, f'graph{self._tag(et)}_rank{self.rank}.npz'),
            rows=rows[m], cols=cols[m], eids=eids[m])
    for nt in ntypes:
      feat = self._sel(self.node_feat, nt)
      if feat is None:
        continue
      feat = np.asarray(feat)
      fids = self._sel(self.node_feat_ids, nt)
      fids = (np.asarray(fids) if fids is not None
              else np.arange(feat.shape[0]))
      pb = node_pbs[nt]
      for p in range(self.num_parts):
        spool = os.path.join(self.output_dir, f'part{p}', '_spool')
        os.makedirs(spool, exist_ok=True)
        fm = pb[fids] == p
        np.savez(os.path.join(
            spool, f'feat{self._tag(nt)}_rank{self.rank}.npz'),
            feats=feat[fm], ids=fids[fm])
    self._barrier()

    # phase 2: each rank merges the partitions it owns (round-robin)
    for p in range(self.rank, self.num_parts, self.world_size):
      part_dir = os.path.join(self.output_dir, f'part{p}')
      spool = os.path.join(part_dir, '_spool')
      for et in etypes:
        pre = f'graph{self._tag(et)}_rank'
        chunks = sorted(f for f in os.listdir(spool) if f.startswith(pre))
        rows_l, cols_l, eids_l = [], [], []
        for f in chunks:
          with np.load(os.path.join(spool, f)) as z:
            rows_l.append(z['rows'])
            cols_l.append(z['cols'])
            eids_l.append(z['eids'])
        payload = dict(rows=np.concatenate(rows_l),
                       cols=np.concatenate(cols_l),
                       eids=np.concatenate(eids_l))
        if et is None:
          np.savez(os.path.join(part_dir, 'graph.npz'), **payload)
        else:
          d = os.path.join(part_dir, 'graph')
          os.makedirs(d, exist_ok=True)
          np.savez(os.path.join(d, f'{_type_str(et)}.npz'), **payload)
      for nt in ntypes:
        pre = f'feat{self._tag(nt)}_rank'
        chunks = sorted(f for f in os.listdir(spool) if f.startswith(pre))
        if not chunks:
          continue
        feats_l, ids_l = [], []
        for f in chunks:
          with np.load(os.path.join(spool, f)) as z:
            feats_l.append(z['feats'])
            ids_l.append(z['ids'])
        ids = np.concatenate(ids_l)
        order = np.argsort(ids)
        payload = dict(feats=np.concatenate(feats_l)[order],
                       ids=ids[order])
        if nt is None:
          np.savez(os.path.join(part_dir, 'node_feat.npz'), **payload)
        else:
          d = os.path.join(part_dir, 'node_feat')
          os.makedirs(d, exist_ok=True)
          np.savez(os.path.join(d, f'{nt}.npz'), **payload)
      shutil.rmtree(spool)
    # all ranks must finish merging before rank 0 reads the merged graphs
    # to rebuild the edge books
    self._barrier()

    if self.rank == 0:
      self._write_books_and_meta(node_pbs, ntypes, etypes)
    self._barrier()
    if self._server is not None:
      self._server.shutdown()
    return self.output_dir

  def _edge_pb_from_merged(self, et) -> np.ndarray:
    """Rebuild the edge book from the merged per-partition graphs."""
    total = 0
    loads = []
    for p in range(self.num_parts):
      path = (os.path.join(self.output_dir, f'part{p}', 'graph.npz')
              if et is None else
              os.path.join(self.output_dir, f'part{p}', 'graph',
                           f'{_type_str(et)}.npz'))
      with np.load(path) as z:
        eids = z['eids']
      loads.append(eids)
      total = max(total, int(eids.max()) + 1 if eids.size else 0)
    pb = np.zeros(total, dtype=np.int32)
    for p, eids in enumerate(loads):
      pb[eids] = p
    return pb

  def _write_books_and_meta(self, node_pbs, ntypes, etypes):
    if self.is_hetero:
      nd = os.path.join(self.output_dir, 'node_pb')
      os.makedirs(nd, exist_ok=True)
      for nt in ntypes:
        np.save(os.path.join(nd, f'{nt}.npy'), node_pbs[nt])
      ed = os.path.join(self.output_dir, 'edge_pb')
      os.makedirs(ed, exist_ok=True)
      for et in etypes:
        np.save(os.path.join(ed, f'{_type_str(et)}.npy'),
                self._edge_pb_from_merged(et))
      meta = dict(num_parts=self.num_parts, hetero=True,
                  node_types=ntypes,
                  edge_types=[list(et) for et in etypes])
    else:
      np.save(os.path.join(self.output_dir, 'node_pb.npy'),
              node_pbs[None])
      np.save(os.path.join(self.output_dir, 'edge_pb.npy'),
              self._edge_pb_from_merged(None))
      meta = dict(num_parts=self.num_parts, hetero=False)
    with open(os.path.join(self.output_dir, 'META.json'), 'w') as f:
      json.dump(meta, f)
