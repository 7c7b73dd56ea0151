"""Induced-subgraph extraction with fixed shapes.

Counterpart of ``graphlearn_tpu/ops/subgraph.py`` (``node_subgraph``,
``node_subgraph_bucketed``) in plain torch: given a node set, keep every
edge whose endpoints are both in it, relabeled to local indices. Rows are
scanned up to a static ``max_degree`` (or two degree buckets), and
membership is a ``searchsorted`` over the deduped node set, with no draw
and no host sync. ``node_subgraph_local`` is the distributed engine's
extraction over a partition-local CSR.
"""
import torch

from .unique import FILL, masked_unique


def _scan(indices, skeys, row_pos, row_mask, start, deg, cap: int):
  """Rows ``row_pos`` (their ``start`` / ``deg``) scanned to ``cap``
  columns against the node keys: flat ``(rows, cols, epos, member)``."""
  n = row_pos.shape[0]
  b = skeys.shape[0]
  dev = skeys.device
  st = torch.where(row_mask, start, 0).to(torch.int64)
  dg = torch.where(row_mask, deg, 0).to(torch.int64)
  off = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
  in_row = off < dg[:, None]
  epos = torch.where(in_row, st[:, None] + off, 0)
  if indices.shape[0]:
    nbr = torch.where(in_row, indices[epos], FILL)
  else:
    nbr = torch.full(epos.shape, FILL, dtype=indices.dtype, device=dev)
  pos = torch.searchsorted(skeys, nbr.contiguous()).clamp(0, b - 1)
  member = in_row & (skeys[pos] == nbr)
  rows = torch.where(member, row_pos.to(torch.int32)[:, None].expand(n, cap),
                     -1)
  cols = torch.where(member, pos.to(torch.int32), -1)
  return (rows.reshape(-1), cols.reshape(-1),
          torch.where(member, epos, 0).reshape(-1), member.reshape(-1))


def _node_set(indptr, srcs, src_mask):
  """``(nodes, num_nodes, valid, search keys, start, deg)`` of the
  deduped node set (ascending, FILL-padded; padding keyed int-max)."""
  b = srcs.shape[0]
  nodes, num_nodes, _ = masked_unique(srcs, src_mask, size=b)
  valid = torch.arange(b, device=srcs.device) < num_nodes
  safe = torch.where(valid, nodes, 0).long()
  start = indptr[safe]
  deg = torch.where(valid, indptr[safe + 1] - start, 0)
  skeys = torch.where(valid, nodes, torch.iinfo(nodes.dtype).max)
  return nodes, num_nodes, valid, skeys, start, deg


def node_subgraph(indptr, indices, srcs, src_mask, max_degree: int):
  """The subgraph induced by ``srcs[src_mask]``.

  Returns a dict: ``nodes [B]`` (ascending, FILL-padded; local index ==
  position), ``num_nodes``, and ``[B * max_degree]`` ``rows``, ``cols``
  (relabeled, -1 where invalid), ``epos`` (CSR positions, 0 where
  invalid) and ``edge_mask``."""
  b = srcs.shape[0]
  nodes, num_nodes, valid, skeys, start, deg = _node_set(indptr, srcs,
                                                         src_mask)
  all_pos = torch.arange(b, dtype=torch.int32, device=srcs.device)
  rows, cols, epos, member = _scan(indices, skeys, all_pos, valid,
                                   start, deg, max_degree)
  return dict(nodes=nodes, num_nodes=num_nodes, rows=rows, cols=cols,
              epos=epos, edge_mask=member)


def node_subgraph_bucketed(indptr, indices, srcs, src_mask, deg_small: int,
                           cap_large: int, max_degree: int):
  """Degree-bucketed :func:`node_subgraph`: rows of degree <= deg_small
  scan ``deg_small`` columns, up to ``cap_large`` higher-degree rows (in
  position order) scan ``max_degree``, and the higher-degree rows beyond
  ``cap_large`` lose their edges, counted in ``num_dropped_rows``. The
  edge arrays are ``B * deg_small + min(cap_large, B) * max_degree``
  wide."""
  b = srcs.shape[0]
  dev = srcs.device
  nodes, num_nodes, valid, skeys, start, deg = _node_set(indptr, srcs,
                                                         src_mask)
  is_small = valid & (deg <= deg_small)
  is_large = valid & (deg > deg_small)
  all_pos = torch.arange(b, dtype=torch.int32, device=dev)
  r1, c1, e1, m1 = _scan(indices, skeys, all_pos, is_small, start,
                         deg, deg_small)
  order = torch.argsort(torch.where(is_large, 0, 1).to(torch.int32),
                        stable=True)
  lpos = order[:cap_large]
  r2, c2, e2, m2 = _scan(indices, skeys, lpos.to(torch.int32),
                         is_large[lpos], start[lpos], deg[lpos], max_degree)
  num_large = is_large.sum().to(torch.int32)
  return dict(nodes=nodes, num_nodes=num_nodes, rows=torch.cat([r1, r2]),
              cols=torch.cat([c1, c2]), epos=torch.cat([e1, e2]),
              edge_mask=torch.cat([m1, m2]),
              num_dropped_rows=torch.clamp(num_large - cap_large, min=0))


def node_subgraph_local(row_ids, indptr_loc, indices, node_keys,
                        max_degree: int):
  """Induced-subgraph extraction over a partition-local CSR
  (``graphlearn_tpu/ops/subgraph.py:node_subgraph_local``).

  ``node_keys`` is the ascending node set, padding int-max. The shard
  finds the set's nodes it owns (a binary search of ``row_ids``), scans
  each owned row to ``max_degree`` and keeps the edges whose other end is
  in the set, relabeled to positions in ``node_keys``. Returns a dict of
  ``[B * max_degree]`` ``rows`` / ``cols`` (-1 where invalid), ``epos``
  (local CSR positions, 0 where invalid) and ``edge_mask``."""
  b = node_keys.shape[0]
  dev = node_keys.device
  big = torch.iinfo(node_keys.dtype).max
  node_valid = node_keys != big
  rpos = torch.searchsorted(row_ids, node_keys).clamp(0, row_ids.shape[0] - 1)
  owned = node_valid & (row_ids[rpos] == node_keys)
  start = torch.where(owned, indptr_loc[rpos], 0).to(torch.int64)
  deg = torch.where(owned, indptr_loc[rpos + 1] - indptr_loc[rpos],
                    0).to(torch.int64)
  off = torch.arange(max_degree, dtype=torch.int64, device=dev)[None, :]
  in_row = off < deg[:, None]
  epos = torch.where(in_row, start[:, None] + off, 0)
  if indices.shape[0]:
    nbr = torch.where(in_row, indices[epos], big)
  else:
    nbr = torch.full(epos.shape, big, dtype=node_keys.dtype, device=dev)
  pos = torch.searchsorted(node_keys, nbr.contiguous()).clamp(0, b - 1)
  member = in_row & (node_keys[pos] == nbr)
  rows = torch.where(member, torch.arange(b, dtype=torch.int32,
                                          device=dev)[:, None], -1)
  cols = torch.where(member, pos.to(torch.int32), -1)
  return dict(rows=rows.reshape(-1), cols=cols.reshape(-1),
              epos=torch.where(member, epos, 0).reshape(-1),
              edge_mask=member.reshape(-1))
