"""Graph and feature partitioning with the JAX package's on-disk layout
(counterpart of ``graphlearn_tpu/partition/``): ``RandomPartitioner``,
``FrequencyPartitioner`` (hotness-aware, with per-partition caches fed by
``NeighborSampler.sample_prob``), ``load_partition`` and
``cat_feature_cache``. Host-side numpy: a directory either package wrote
loads in the other."""
from .base import PartitionerBase, cat_feature_cache, load_partition
from .frequency_partitioner import FrequencyPartitioner
from .random_partitioner import RandomPartitioner
