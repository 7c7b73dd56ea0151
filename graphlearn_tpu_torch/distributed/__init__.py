"""The partitioned (distributed) sampling path and the remote stack.

Counterpart of ``graphlearn_tpu/distributed``: ``init_worker_group`` (all
P shards in this process, on one device) and ``init_multihost`` (one
shard per process of a ``torch.distributed`` group), ``ShardMesh``,
``DistGraph`` / ``DistHeteroGraph``, ``DistFeature``,
``DistNeighborSampler`` (node, link and subgraph sampling, homogeneous
and typed), ``DistDataset``, ``DistLoader``, ``DistNeighborLoader``,
``DistLinkNeighborLoader``, ``DistSubGraphLoader``; the distributed
trainers over these are ``loader.DistFusedEpochTrainer`` /
``loader.DistScanTrainer``.

The per-batch remote stack: the mp loaders (``MpDistNeighborLoader``,
``MpDistLinkNeighborLoader``) over ``DistMpSamplingProducer`` (sampling
worker processes on the dataset's device feeding a shared-memory
channel), the TCP RPC (``RpcServer`` / ``RpcClient`` with the mutual
HMAC handshake, ``Barrier``) and its resilience layer (``RetryPolicy``,
``Heartbeat``), ``DistServer`` with ``init_server`` /
``wait_and_shutdown_server``, the client calls (``init_client``,
``request_server``, ``shutdown_client``) and the remote loaders
(``RemoteDistNeighborLoader``, ``RemoteDistLinkNeighborLoader``); then
``DistRandomPartitioner`` and ``DistTableDataset`` over the RPC's
``Barrier``.

The chunk-staged remote scan: server-side K-batch block streams
(``BlockSampleProducer``, ``stack_block_frames``, ``block_mb_per_chunk``)
and ``RemoteScanTrainer`` with its ``RemoteBlockStager``; and the
multi-tenant plane of the sampling servers (``TenancyConfig``,
``TenantSpec``, ``AdmissionController``, ``WeightedFairScheduler``, the
typed ``TenantRejection`` errors and ``with_backpressure``).
"""
from .dist_context import (DistContext, DistRole, ShardMesh, get_context,
                           init_multihost, init_worker_group,
                           reset_verdict_syncs, verdict_syncs)
from .dist_dataset import DistDataset
from .dist_random_partitioner import DistRandomPartitioner, shared_node_pb
from .dist_table_dataset import DistTableDataset
from .dist_feature import DistFeature, feature_exchange_mb, miss_capacity
from .dist_graph import DistGraph, DistHeteroGraph, build_local_csr
from .dist_loader import (DistLinkNeighborLoader, DistLoader,
                          DistNeighborLoader, DistSubGraphLoader,
                          MpDistLinkNeighborLoader, MpDistNeighborLoader,
                          RemoteDistLinkNeighborLoader,
                          RemoteDistNeighborLoader)
from .dist_neighbor_sampler import DistNeighborSampler
from .dist_options import (CollocatedDistSamplingWorkerOptions,
                           MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import (DistCollocatedSamplingProducer,
                                     DistMpSamplingProducer)
from .block_producer import (BlockSampleProducer, block_mb_per_chunk,
                             stack_block_frames)
from .remote_scan import RemoteBlockStager, RemoteScanTrainer
from .dist_server import (DistServer, get_server, init_server,
                          wait_and_shutdown_server)
from .dist_client import (async_request_server, init_client,
                          request_server, shutdown_client)
from .event_loop import ConcurrentEventLoop
from .message import message_to_data, output_to_message
from .resilience import (DEFAULT_RETRY_POLICY, NO_RETRY, DeadlineExceeded,
                         Heartbeat, RetryPolicy, ServerDeadError)
from .rpc import (Barrier, RpcCalleeBase, RpcClient,
                  RpcDataPartitionRouter, RpcServer, get_free_port)
from .tenancy import (PRIORITY_CLASSES, AdmissionController, TenancyConfig,
                      TenantQuotaExceeded, TenantRejection, TenantSpec,
                      TenantStarvedError, TenantThrottled,
                      WeightedFairScheduler, with_backpressure)
