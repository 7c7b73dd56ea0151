"""The single-replica embedding store the online engine answers from.

Counterpart of ``graphlearn_tpu/serving/store.py`` (``pow2_cap``,
``EmbeddingStore``): a device-resident ``[N_pad, F]`` table behind one
``lookup(ids, mask) -> rows`` surface. With ``set_kernel_routing(
use_pallas_v2=True)`` every lookup goes through the run-segmented
gather-v2 kernel (``ops.gather_rows_hbm2``) at any row width; without
routing it is plain indexing, as in the JAX package.
``TieredEmbeddingStore`` serves a table beyond the device from a
``storage.TieredFeature``. ``DistEmbeddingStore`` serves a table sharded
over a ``distributed.ShardMesh`` through ``DistFeature``'s cached
miss-only lookup.
"""
from typing import Optional

import numpy as np
import torch

from ..ops.gather import gather_rows_hbm2
from ..utils import resolve_device
from ..utils.trace import record_dispatch


def pow2_cap(n: int, floor: int = 8) -> int:
  """The padded power-of-two bucket capacity for ``n`` items (the
  refresh compute buckets of ``EmbeddingMaterializer.refresh_rows``)."""
  return max(floor, 1 << int(n - 1).bit_length()) if n > 1 else floor


class EmbeddingStore:
  """Single-replica device-resident embedding table.

  Args:
    embeddings: ``[N_pad, F]`` rows, a tensor (its device is the store's)
      or host rows (placed on ``device``; None means the card).
    num_nodes: the real node count. Materializer tables carry block
      padding rows past it, which the engine must never serve; prefer
      ``EmbeddingMaterializer.embedding_store()``, which passes it.
    device: where host ``embeddings`` go.

  The store takes ownership of the table: ``update_rows`` writes into it
  in place.
  """

  granularity = 1

  # tuned kernel routing: route the bucket gather through the
  # run-segmented kernel (ops.gather_rows_hbm2) at this grid point
  use_pallas_v2 = False
  pallas_v2_block_rows = 256
  pallas_v2_run_span = 8

  def __init__(self, embeddings, num_nodes: Optional[int] = None,
               device=None):
    if isinstance(embeddings, torch.Tensor):
      self._emb = embeddings.contiguous()
    else:
      self._emb = torch.as_tensor(np.ascontiguousarray(embeddings)).to(
          resolve_device(device))
    self.device = self._emb.device
    self.num_nodes = int(num_nodes if num_nodes is not None
                         else self._emb.shape[0])

  def set_kernel_routing(self, use_pallas_v2: bool = False,
                         block_rows: int = 256, run_span: int = 8):
    """Apply a tuned kernel choice to the lookup gather; the buckets and
    the answers are unchanged (the kernel equals plain indexing)."""
    self.use_pallas_v2 = bool(use_pallas_v2)
    self.pallas_v2_block_rows = int(block_rows)
    self.pallas_v2_run_span = int(run_span)

  @property
  def feature_dim(self) -> int:
    return int(self._emb.shape[1])

  @property
  def table(self) -> torch.Tensor:
    """The live ``[N_pad, F]`` table (updated in place by refreshes)."""
    return self._emb

  def lookup(self, ids, mask) -> torch.Tensor:
    """``[cap]`` padded ids (-1 pads, mask False) -> ``[cap, F]`` device
    rows, pad slots zeroed. Ids are clamped into the table, as the JAX
    store's gather clamps them (an id past ``N_pad`` reads the last row)."""
    record_dispatch('serve_lookup')
    ids = torch.as_tensor(ids).to(self.device)
    mask = torch.as_tensor(mask).to(self.device)
    safe = torch.clamp(ids, 0, self._emb.shape[0] - 1)
    if self.use_pallas_v2:
      rows = gather_rows_hbm2(self._emb, safe.contiguous(),
                              block_rows=self.pallas_v2_block_rows,
                              run_span=self.pallas_v2_run_span)
    else:
      rows = self._emb[safe.to(torch.int64)]
    return rows.masked_fill_(~mask[:, None], 0)

  def fetch(self, rows) -> np.ndarray:
    """Device rows -> host (the engine's single fetch per batch)."""
    return rows.cpu().numpy()

  def update_rows(self, ids, rows):
    """Refresh write-back: ``table[ids] = rows`` in place. Only the real
    rows are written (the JAX store pads to a power-of-two capacity and
    drops the pad writes)."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size == 0:
      return
    record_dispatch('serve_store_update')
    vals = torch.as_tensor(np.asarray(rows)).to(self.device,
                                                self._emb.dtype)
    self._emb[torch.as_tensor(ids).to(self.device)] = vals


class TieredEmbeddingStore:
  """Embedding store beyond the device: the materialized table lives in a
  ``storage.TieredFeature`` (device hot prefix, host RAM, disk), so a
  table larger than device memory still serves. Hot and warm rows come
  from one launch of the hot/cold kernel on a card; disk rows are read on
  the host and shipped in one pinned copy. The engine's ids arrive on the
  host, so a lookup makes no host sync. Pair it with
  ``EmbeddingMaterializer(..., spill_dir=...)`` and
  ``tiered_embedding_store(...)``.

  Immutable, as in JAX: stale rows are refreshed by materializing again
  and rotating the spill, not by in-place writes (the hot tier is on the
  device, the rest on the host, and a write-through across tiers would
  race the staging).
  """

  granularity = 1

  def __init__(self, tiered_feature, num_nodes: Optional[int] = None):
    self.tf = tiered_feature
    self.num_nodes = int(num_nodes if num_nodes is not None
                         else tiered_feature.size)
    self.device = tiered_feature.device

  @property
  def feature_dim(self) -> int:
    return int(self.tf.shape[1])

  def lookup(self, ids, mask) -> torch.Tensor:
    """``[cap]`` padded host ids (-1 pads, mask False) -> ``[cap, F]``
    device rows, pad slots zeroed, as ``EmbeddingStore.lookup``."""
    record_dispatch('serve_lookup')
    rows = self.tf[np.asarray(ids)]
    mask = torch.as_tensor(np.asarray(mask, bool))
    if rows.device.type == 'cuda':
      mask = mask.pin_memory().to(rows.device, non_blocking=True)
    return rows.masked_fill_(~mask[:, None], 0)

  def fetch(self, rows) -> np.ndarray:
    return rows.cpu().numpy()

  def update_rows(self, ids, rows):
    raise NotImplementedError(
        'TieredEmbeddingStore rows are immutable: materialize again with '
        'EmbeddingMaterializer(..., spill_dir=...) and rotate the spill')


class DistEmbeddingStore:
  """Sharded embedding store over a mesh: a ``DistFeature`` whose rows are
  the materialized embeddings. Its hot cache is the ``DistFeature``'s
  replicated hot split (``split_ratio`` / ``cache_rows`` + ``hotness``),
  and every lookup is its cached miss-only exchange (K1 for the cache and
  the owners' rows on a card). Bucket capacities must be multiples of the
  partition count (``granularity``): the engine spreads each padded bucket
  ``[cap] -> [P, cap/P]``, so the lookup load-balances over the shards.
  """

  def __init__(self, dist_feature):
    self.df = dist_feature
    self.granularity = int(dist_feature.num_partitions)
    self.num_nodes = int(dist_feature.feature_pb.shape[0])

  @classmethod
  def build(cls, embeddings, mesh, *, split_ratio: float = 0.0,
            cache_rows: Optional[int] = None, hotness=None,
            wire_dtype=None, bucket_frac=2.0,
            num_nodes: Optional[int] = None):
    """Partition a materialized ``[N(_pad), F]`` table into a
    ``DistFeature`` over ``mesh`` (contiguous row blocks). Pass
    ``num_nodes`` for materializer tables: it trims the block-padding
    rows, which would otherwise be servable ids (prefer
    ``EmbeddingMaterializer.dist_embedding_store``)."""
    from ..distributed.dist_feature import DistFeature
    emb = embeddings
    if isinstance(emb, torch.Tensor):
      emb = emb.detach().cpu()
    emb = np.asarray(emb)
    if num_nodes is not None:
      emb = emb[:num_nodes]
    n = emb.shape[0]
    p = int(mesh.num_partitions)
    pb = np.minimum((np.arange(n, dtype=np.int64) * p) // max(n, 1),
                    p - 1).astype(np.int32)
    parts = []
    for i in range(p):
      ids = np.where(pb == i)[0].astype(np.int64)
      if ids.size == 0:   # more shards than rows: keep a dummy row
        ids = np.zeros((1,), np.int64)
      parts.append((ids, emb[ids]))
    df = DistFeature(p, parts, pb, mesh=mesh, split_ratio=split_ratio,
                     cache_rows=cache_rows, hotness=hotness,
                     wire_dtype=wire_dtype, bucket_frac=bucket_frac)
    return cls(df)

  @property
  def feature_dim(self) -> int:
    return int(self.df.feature_dim)

  def lookup(self, ids, mask):
    """``[cap]`` padded ids -> ``[L, cap/P, F]`` sharded device rows
    (reshaped back to ``[cap, F]`` by :meth:`fetch`)."""
    ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                          else ids).to(torch.int32)
    mask = torch.as_tensor(np.asarray(mask, bool) if not
                           torch.is_tensor(mask) else mask)
    cap = int(ids.shape[0])
    p = self.granularity
    assert cap % p == 0, (
        f'bucket capacity {cap} must be a multiple of the partition '
        f'count {p} (engine bucket calibration)')
    return self.df.get(ids.reshape(p, cap // p), mask.reshape(p, cap // p))

  def fetch(self, rows) -> np.ndarray:
    out = rows.cpu().numpy()
    return out.reshape(-1, out.shape[-1])

  def publish_stats(self):
    """The hot-embedding cache's hit / miss counters since the last call
    into the registry (``dist_feature.*``, one device read), then
    cleared — the training feature cache's once-per-epoch discipline.
    Returns the read counters."""
    return self.df.publish_stats()

  def update_rows(self, ids, rows):
    raise NotImplementedError(
        'DistEmbeddingStore rows are immutable: stale nodes are refreshed '
        'on the materializing replica and the sharded store is rebuilt on '
        'rotation or failover')
