"""Chunk-granular recovery: ``ChunkCheckpointer`` and the snapshot file
format (the port's counterpart of ``graphlearn_tpu/recovery``, without
``FailoverRunner``, which comes with the distributed trainers)."""
from . import snapshot
from .checkpoint import ChunkCheckpointer, config_fingerprint
from .snapshot import (Snapshot, TornSnapshotError, list_snapshots,
                       load_snapshot, write_snapshot)
