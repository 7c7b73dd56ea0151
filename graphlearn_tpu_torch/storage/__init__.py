"""graphlearn_tpu_torch.storage: the out-of-core tiered feature store.

Counterpart of ``graphlearn_tpu/storage`` (single device): a three-tier
feature store (device hot prefix, host-RAM warm tier, memory-mapped disk
cold tier), the epoch prefetch planner and the chunk-boundary staging
that feeds the scanned epoch.

* ``DiskTier`` / ``spill_array``: the chunked mmap bottom tier (the JAX
  package's on-disk layout; either package opens the other's).
* ``TieredFeature``: drop-in for ``data.Feature`` across the three tiers
  (the reactive per-batch lookup and ``cpu_get``).
* ``ChunkStager``: the bounded staging worker (a ring of pinned host
  slabs on a card; degrades to synchronous reads, never to a wrong
  batch).
* ``planner``: the exact per-chunk miss sets of an epoch, from the
  replayable seed and ``fold_in`` streams.
* ``TieredScanTrainer``: the scanned epoch over a ``TieredFeature``, its
  chunks captured as CUDA graphs on a card.

* ``TieredDistFeature`` / ``spill_partitions``: the sharded store with
  per-partition disk tiers (the demand-paged per-step ``get``), and
  ``DistChunkStager`` / ``TieredDistScanTrainer``: the scanned
  distributed epoch over each shard's hot prefix and staged slabs.
"""
from . import planner
from .disk import DiskTier, spill_array
from .dist import TieredDistFeature, spill_partitions
from .dist_scan import DistChunkStager, TieredDistScanTrainer
from .scan import TieredScanTrainer, tiered_gather
from .staging import ChunkStager, pad_slab, pow2_slab_cap
from .tiered import TieredFeature

__all__ = [
    'DiskTier', 'spill_array', 'TieredDistFeature', 'spill_partitions',
    'DistChunkStager', 'TieredDistScanTrainer', 'TieredScanTrainer', 'tiered_gather',
    'ChunkStager', 'pad_slab', 'pow2_slab_cap', 'TieredFeature', 'planner',
]
