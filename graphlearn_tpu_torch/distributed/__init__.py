"""The partitioned (distributed) sampling path.

Counterpart of ``graphlearn_tpu/distributed``'s homogeneous node path:
``init_worker_group`` (all P shards in this process, on one device) and
``init_multihost`` (one shard per process of a ``torch.distributed``
group), ``ShardMesh``, ``DistGraph`` / ``DistHeteroGraph``,
``DistFeature``, ``DistNeighborSampler``, ``DistDataset``, ``DistLoader``
and ``DistNeighborLoader``. The distributed trainers over these are
``loader.DistFusedEpochTrainer`` / ``loader.DistScanTrainer`` (failover:
``recovery.FailoverRunner``; out of core: ``storage.TieredDistFeature``
and ``storage.TieredDistScanTrainer``). The dist link, subgraph and typed
samplers and loaders, the multiprocess and remote loaders and the
servers come with later slices.
"""
from .dist_context import (DistContext, DistRole, ShardMesh, get_context,
                           init_multihost, init_worker_group,
                           reset_verdict_syncs, verdict_syncs)
from .dist_dataset import DistDataset
from .dist_feature import DistFeature, feature_exchange_mb, miss_capacity
from .dist_graph import DistGraph, DistHeteroGraph, build_local_csr
from .dist_loader import DistLoader, DistNeighborLoader
from .dist_neighbor_sampler import DistNeighborSampler
from ..utils.common import get_free_port  # JAX's distributed exports it
