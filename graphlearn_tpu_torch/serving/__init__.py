"""graphlearn_tpu_torch.serving: the inference tier, homogeneous and
single-replica.

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

Both halves run the model through ``models.train.make_layer_slice_fn``,
slices of the same forward as sampled inference.
"""
from .engine import DEFAULT_BUCKETS, ServingEngine
from .materialize import (EmbeddingMaterializer, padded_neighbors,
                          warm_embedding_store)
from .store import EmbeddingStore, TieredEmbeddingStore

__all__ = [
    'DEFAULT_BUCKETS', 'EmbeddingMaterializer', 'EmbeddingStore',
    'ServingEngine', 'TieredEmbeddingStore', 'padded_neighbors',
    'warm_embedding_store',
]
