"""graphlearn_tpu_torch.serving: the inference tier.

- Offline: :class:`EmbeddingMaterializer`, layer-wise full-graph
  embedding materialization over the ``padded_neighbors`` table, each
  layer's output becoming the next layer's feature store.
- Online: :class:`ServingEngine`, admission batching into padded buckets
  over an :class:`EmbeddingStore`, with final-layer refresh of stale
  nodes and ``serving.*`` metrics. With ``set_kernel_routing(
  use_pallas_v2=True)`` the store's lookup is the gather-v2 kernel.
- Beyond the device: ``EmbeddingMaterializer(spill_dir=)`` writes each
  layer pass to a disk tier, :class:`TieredEmbeddingStore` serves the
  spilled table from a ``storage.TieredFeature`` and
  :func:`warm_embedding_store` reopens it after a restart.
- Sharded: :class:`DistEmbeddingStore` (or
  ``EmbeddingMaterializer.dist_embedding_store(mesh)``) serves the table
  over a ``distributed.ShardMesh`` through ``DistFeature``'s cached
  lookup; the engine's buckets are multiples of its ``granularity``.
  :class:`RotatingShardedStore` swaps whole table versions in under live
  traffic (per-shard disk tiers, one atomic flip), on a schedule with
  :class:`RotationScheduler`.

Both halves run the model through ``models.train.make_layer_slice_fn``,
slices of the same forward as sampled inference.
"""
from .engine import DEFAULT_BUCKETS, ServingEngine
from .materialize import (EmbeddingMaterializer, padded_neighbors,
                          warm_embedding_store)
from .rotation import RotatingShardedStore, RotationScheduler
from .store import DistEmbeddingStore, EmbeddingStore, TieredEmbeddingStore

__all__ = [
    'DEFAULT_BUCKETS', 'DistEmbeddingStore', 'EmbeddingMaterializer',
    'EmbeddingStore', 'RotatingShardedStore', 'RotationScheduler',
    'ServingEngine', 'TieredEmbeddingStore', 'padded_neighbors',
    'warm_embedding_store',
]
