"""Chunk-granular recovery: ``ChunkCheckpointer``, the snapshot file
format and the distributed epoch's ``FailoverRunner`` (the port's
counterpart of ``graphlearn_tpu/recovery``)."""
from . import snapshot
from .checkpoint import ChunkCheckpointer, config_fingerprint
from .failover import FailoverRunner, ShardDeadError, remaining_seeds
from .snapshot import (Snapshot, TornSnapshotError, list_snapshots,
                       load_snapshot, write_snapshot)
