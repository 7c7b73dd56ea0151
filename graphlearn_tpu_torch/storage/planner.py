"""Epoch prefetch planner: the scanned epoch's miss set, known up front.

Counterpart of ``graphlearn_tpu/storage/planner.py``, with the
distributed ``ExchangePlan`` (:func:`plan_exchange`: host numpy, the
same code). The
scanned epoch draws its seed permutation at the prologue and the sampler
derives every step's key from the ``fold_in`` counter stream, so the
epoch's whole feature access set is a pure function of (seeds, perm key,
epoch index, sampler state): the plan is exact, per chunk and per tier.

Two routes give the same plan:

* **Fused (production)**: ``TieredScanTrainer``'s prologue replays the
  sampler on ids only over every step, on the device, from the hop keys
  the chunks will derive, and fetches the ``[steps, node_cap]``
  storage-row matrix once; :func:`plan_from_rows` turns it into per-chunk
  sorted miss sets.
* **Host replay (verification)**: :func:`replay_seed_matrix` repeats the
  seed program's permutation with ``random.permutation`` on the CPU (bit
  equal to JAX's) and :func:`plan_epoch_host` samples step by step.

The plan's unit is the storage row (after the ``id2index`` remap),
clamped exactly like the collate gather (pad slots -> node id 0).
"""
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import random as trandom
from .staging import pow2_slab_cap


@dataclass
class EpochPlan:
  """Per-chunk staging plan for one scanned epoch."""
  chunk_size: int
  hot_rows: int
  warm_rows: int
  # per chunk: sorted unique absolute storage rows >= hot_rows
  chunk_rows: List[np.ndarray] = field(default_factory=list)

  @property
  def num_chunks(self) -> int:
    return len(self.chunk_rows)

  def slab_caps(self) -> List[int]:
    """The pow2 staging capacities of the plan's chunks."""
    return [pow2_slab_cap(int(r.shape[0])) for r in self.chunk_rows]

  def stats(self) -> dict:
    rows = [int(r.shape[0]) for r in self.chunk_rows]
    warm_edge = self.hot_rows + self.warm_rows
    disk = [int(np.sum(r >= warm_edge)) for r in self.chunk_rows]
    return dict(chunks=self.num_chunks, planned_rows=int(sum(rows)),
                planned_disk_rows=int(sum(disk)),
                max_chunk_rows=int(max(rows)) if rows else 0,
                slab_caps=sorted(set(self.slab_caps())))


def rows_for_nodes(nodes: np.ndarray,
                   id2index: Optional[np.ndarray]) -> np.ndarray:
  """Node-id buffer -> storage rows, with the collate gather's clamp
  (FILL=-1 pads -> node id 0 -> that node's storage row)."""
  safe = np.maximum(np.asarray(nodes, np.int64), 0)
  return id2index[safe] if id2index is not None else safe


def plan_from_rows(rows_mat: np.ndarray, chunk_size: int, hot_rows: int,
                   warm_rows: int = 0) -> EpochPlan:
  """Per-chunk miss sets from a ``[steps, cap]`` storage-row matrix
  (already clamped and remapped). Rows below ``hot_rows`` are on the
  device and drop out; the rest dedup per chunk into one sorted list."""
  rows_mat = np.asarray(rows_mat)
  steps = rows_mat.shape[0]
  plan = EpochPlan(chunk_size=int(chunk_size), hot_rows=int(hot_rows),
                   warm_rows=int(warm_rows))
  for start in range(0, steps, chunk_size):
    block = rows_mat[start:start + chunk_size].reshape(-1)
    uniq = np.unique(block)
    plan.chunk_rows.append(uniq[uniq >= hot_rows].astype(np.int64))
  return plan


@dataclass
class ExchangePlan:
  """Per-chunk miss-exchange program for one scanned distributed epoch
  (``storage/dist_scan.py``): which positions of each shard's sorted row
  table its peers (or the shard itself) will request during each chunk,
  beyond the replicated hot cache and the per-partition HBM hot prefix.

  ``chunk_rows[c]`` holds ENCODED sorted staging rows
  ``p * n_max + position`` — the flat address space the dist stager
  decodes back into per-shard slabs. The unit is the POSITION in the
  owning partition's sorted id table (what ``_shard_body`` resolves
  requests to in-program), so "planned" and "served" can never disagree
  on routing."""
  chunk_size: int
  n_max: int
  hot_prefix_rows: int
  num_partitions: int
  chunk_rows: List[np.ndarray] = field(default_factory=list)

  @property
  def num_chunks(self) -> int:
    return len(self.chunk_rows)

  def slab_caps(self) -> List[int]:
    """Per-chunk pow2 PER-SHARD slab capacities (the closed staging
    shape set the chunk programs compile against): the max per-shard
    staged count of the chunk, padded to a power of two."""
    caps = []
    for enc in self.chunk_rows:
      if enc.size:
        per = np.bincount(enc // self.n_max,
                          minlength=self.num_partitions)
        caps.append(pow2_slab_cap(int(per.max())))
      else:
        caps.append(1)
    return caps

  def stats(self) -> dict:
    rows = [int(r.shape[0]) for r in self.chunk_rows]
    return dict(chunks=self.num_chunks, planned_rows=int(sum(rows)),
                max_chunk_rows=int(max(rows)) if rows else 0,
                slab_caps=sorted(set(self.slab_caps())))


def plan_exchange(rows_mat: np.ndarray, chunk_size: int,
                  feature_pb: np.ndarray, feat_ids: np.ndarray,
                  hot_prefix_rows: int,
                  cache_ids: Optional[np.ndarray] = None) -> ExchangePlan:
  """The exact miss-exchange program from the prologue's replayed
  [P, steps, node_cap] node-id matrix (FILL pads < 0).

  Mirrors the in-program lookup exactly: ids hitting the REPLICATED hot
  cache never enter the exchange (the cache split happens before the
  all_to_all), every other requested id routes to its owning partition
  (``feature_pb``) and resolves to a position in that partition's
  sorted id table; positions below the HBM ``hot_prefix_rows`` are
  device-resident and drop out, the rest dedup per chunk into the
  encoded staging list."""
  rows_mat = np.asarray(rows_mat)
  nparts, steps = rows_mat.shape[0], rows_mat.shape[1]
  n_max = feat_ids.shape[1]
  plan = ExchangePlan(chunk_size=int(chunk_size), n_max=int(n_max),
                      hot_prefix_rows=int(hot_prefix_rows),
                      num_partitions=int(nparts))
  feature_pb = np.asarray(feature_pb)
  for start in range(0, steps, chunk_size):
    blk = rows_mat[:, start:start + chunk_size].reshape(-1)
    blk = np.unique(blk[blk >= 0]).astype(np.int64)
    if cache_ids is not None and cache_ids.size:
      cpos = np.clip(np.searchsorted(cache_ids, blk), 0,
                     cache_ids.shape[0] - 1)
      blk = blk[cache_ids[cpos] != blk]
    owners = feature_pb[blk]
    enc = []
    for p in range(nparts):
      ids_p = blk[owners == p]
      pos = np.clip(np.searchsorted(feat_ids[p], ids_p), 0, n_max - 1)
      found = feat_ids[p][pos] == ids_p
      stage = pos[found & (pos >= hot_prefix_rows)].astype(np.int64)
      if stage.size:
        enc.append(p * n_max + stage)
    plan.chunk_rows.append(
        np.sort(np.concatenate(enc)) if enc else
        np.zeros((0,), np.int64))
  return plan


def replay_seed_matrix(seeds: np.ndarray, perm_key, steps: int,
                       batch: int, shuffle: bool,
                       nparts: int = 1) -> tuple:
  """Host replay of the scanned trainers' seed programs: ``(seed_mat,
  mask_mat)`` as ``ScanTrainer._epoch_seeds`` computes them on the
  device (``nparts == 1``: ``[steps, batch]``, zero-padded ragged tail)
  or, for ``nparts > 1``, as JAX's ``DistScanTrainer`` does (``[P,
  steps, batch]``, cyclic-padded tail). ``random.permutation`` on the CPU
  is bit-equal to the device's and to ``jax.random.permutation``."""
  seeds = np.asarray(seeds, np.int32)
  n = seeds.shape[0]
  order = (trandom.permutation(perm_key, n, 'cpu').numpy() if shuffle
           else np.arange(n, dtype=np.int32))
  total = steps * nparts * batch
  if total <= n:
    ext = order[:total]
    maskf = np.ones((total,), bool)
  elif nparts == 1:
    ext = np.concatenate([order, np.zeros((total - n,), order.dtype)])
    maskf = np.arange(total) < n
  else:
    pad = order[np.arange(total - n, dtype=np.int64) % n]
    ext = np.concatenate([order, pad])
    maskf = np.arange(total) < n
  if nparts == 1:
    seed_mat = np.where(maskf, seeds[ext], 0).reshape(steps, batch)
    return seed_mat, maskf.reshape(steps, batch)
  seed_mat = seeds[ext].reshape(steps, nparts, batch).transpose(1, 0, 2)
  mask_mat = maskf.reshape(steps, nparts, batch).transpose(1, 0, 2)
  return seed_mat, mask_mat


def plan_epoch_host(sampler, seeds: np.ndarray, perm_key, steps: int,
                    batch: int, shuffle: bool, chunk_size: int,
                    hot_rows: int, warm_rows: int = 0,
                    id2index: Optional[np.ndarray] = None,
                    count0: Optional[int] = None) -> EpochPlan:
  """The verification route: replay the permutation and the sampler's
  per-step draws step by step (step ``g`` under ``fold_in(base_key,
  count0 + g)``, as the per-step loop draws) and build the plan the
  fused prologue must match. Tooling, not the production prologue."""
  seed_mat, mask_mat = replay_seed_matrix(seeds, perm_key, steps, batch,
                                          shuffle)
  if count0 is None:
    count0 = sampler._call_count + 1
  device = sampler.device
  rows = []
  for g in range(steps):
    key = trandom.fold_in(sampler._key, count0 + g)
    res = sampler._sample(torch.as_tensor(seed_mat[g]).to(device),
                          torch.as_tensor(mask_mat[g]).to(device), key=key)
    rows.append(rows_for_nodes(res['node'].cpu().numpy(), id2index))
  return plan_from_rows(np.stack(rows), chunk_size, hot_rows, warm_rows)
