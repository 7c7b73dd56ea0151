"""The partitioned (distributed) sampling path.

Counterpart of ``graphlearn_tpu/distributed``'s homogeneous node path:
``init_worker_group`` (all P shards in this process, on one device) and
``init_multihost`` (one shard per process of a ``torch.distributed``
group), ``ShardMesh``, ``DistGraph`` / ``DistHeteroGraph``,
``DistFeature``, ``DistNeighborSampler`` (node, link and subgraph
sampling, homogeneous and typed), ``DistDataset``, ``DistLoader``,
``DistNeighborLoader``, ``DistLinkNeighborLoader``, ``DistSubGraphLoader``
and ``shared_node_pb``. The distributed trainers over these are
``loader.DistFusedEpochTrainer`` / ``loader.DistScanTrainer`` (failover:
``recovery.FailoverRunner``; out of core: ``storage.TieredDistFeature``
and ``storage.TieredDistScanTrainer``). The multiprocess and remote
loaders, the servers and ``DistRandomPartitioner`` come with the remote
stack.
"""
from .dist_context import (DistContext, DistRole, ShardMesh, get_context,
                           init_multihost, init_worker_group,
                           reset_verdict_syncs, verdict_syncs)
from .dist_dataset import DistDataset
from .dist_feature import DistFeature, feature_exchange_mb, miss_capacity
from .dist_graph import DistGraph, DistHeteroGraph, build_local_csr
from .dist_loader import (DistLinkNeighborLoader, DistLoader,
                          DistNeighborLoader, DistSubGraphLoader)
from .dist_neighbor_sampler import DistNeighborSampler
from .dist_random_partitioner import shared_node_pb
from ..utils.common import get_free_port  # JAX's distributed exports it
