"""Sampling-worker option bundles.

Counterpart of ``graphlearn_tpu/distributed/dist_options.py``: the three
deployment shapes, collocated (sampling in the training process's own
step), mp (sampling in worker processes feeding a shared-memory
channel) and remote (sampling on server processes, batches streamed to
clients over the RPC).
"""
from dataclasses import dataclass
from typing import List, Optional, Union


@dataclass
class _BasicDistSamplingWorkerOptions:
  """The options every shape shares."""
  num_workers: int = 1
  worker_concurrency: int = 4
  master_addr: Optional[str] = None
  master_port: Optional[Union[str, int]] = None
  channel_size: Optional[Union[int, str]] = None
  pin_memory: bool = False
  rpc_timeout: float = 180.0


@dataclass
class CollocatedDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Sampling runs in the training process, on its mesh."""
  use_all2all: bool = True


@dataclass
class MpDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Sampling worker processes and a shared-memory channel."""
  channel_capacity: int = 128


@dataclass
class RemoteDistSamplingWorkerOptions(_BasicDistSamplingWorkerOptions):
  """Server-side producers streaming to this client.

  Resilience tunables: the loader heartbeats
  every server at ``heartbeat_interval`` seconds and declares one dead
  after ``heartbeat_miss`` consecutive missed probes (detection latency
  ~ interval * miss, vs the 180 s socket timeout). With ``failover``
  on, a dead server's unacknowledged seeds are redistributed across the
  surviving servers so the epoch still completes (node loaders only —
  link batches carry no seed provenance to ack). ``rpc_timeout`` doubles
  as the total-idle budget: an epoch that receives nothing for that
  long fails with a contextual QueueTimeoutError.

  The chunk-staged scan's tunables (``RemoteScanTrainer``):
  ``block_wire_dtype`` (None, or 'bf16' for half-width frame features),
  ``block_ahead`` (frames prefetched ahead of the chunk that trains, and
  the client's pinned slots) and ``block_timeout`` (how long a chunk
  waits for its prefetch before fetching synchronously). The tenancy
  ones: ``tenant``, ``tenant_priority`` and ``tenant_weight`` register
  the client's producers with a server's admission controller, and
  ``backpressure_budget`` bounds the seconds of throttle waits before
  ``TenantStarvedError``.
  """
  server_rank: Optional[Union[int, List[int]]] = None
  buffer_size: Optional[Union[int, str]] = None
  prefetch_size: int = 4
  worker_key: Optional[str] = None
  epochs: int = 1
  heartbeat_interval: float = 1.0
  heartbeat_miss: int = 3
  failover: bool = True
  block_wire_dtype: Optional[str] = None
  block_ahead: int = 2
  block_timeout: float = 30.0
  tenant: Optional[str] = None
  tenant_priority: Optional[str] = None
  tenant_weight: Optional[float] = None
  backpressure_budget: float = 120.0


AllDistSamplingWorkerOptions = Union[
    CollocatedDistSamplingWorkerOptions,
    MpDistSamplingWorkerOptions,
    RemoteDistSamplingWorkerOptions,
]
