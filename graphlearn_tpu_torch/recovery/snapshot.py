"""Atomic, torn-proof chunk-boundary snapshots.

The port's copy of ``graphlearn_tpu/recovery/snapshot.py``, in numpy
only, with the same file format, so each package reads the other's
files. One snapshot holds what the counter-addressed draws do not
replay for free: the train state, the losses and accuracies already
produced, the epoch and chunk position, the sampler's ``state_dict``
(base key and counter), the overflow flag and a trainer's extras. The
seed permutation and every later draw are functions of these.

File format (one self-validating file)::

    MAGIC 'GLTCKPT1' | u32be header_len | header JSON | npz payload

The header carries the payload's length and sha256, so a torn write is
always detected (:class:`TornSnapshotError`), never restored. A write is
atomic: the bytes go to a temporary file in the same directory, which is
fsync'd and ``os.replace``'d onto the final name, and the directory entry
is fsync'd. JAX's fault sites sit where JAX has them: ``recovery.save``
at the top of :func:`write_snapshot` (the checkpointer's writer thread
and its degraded synchronous path both write through it) and
``recovery.restore`` at the top of :func:`load_snapshot`.
"""
import hashlib
import io
import json
import os
import re
import struct
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.checkpoint import _dejsonify, _jsonify
from ..utils.faults import fault_point

MAGIC = b'GLTCKPT1'
_NAME_RE = re.compile(r'^ckpt-(\d+)-(\d+)\.glt$')


class TornSnapshotError(RuntimeError):
  """A snapshot file failed its integrity check (truncated header,
  payload length or sha256 mismatch): the restore path skips it and falls
  back to the previous snapshot."""


@dataclass
class Snapshot:
  """A loaded, validated snapshot: JSON meta and named numpy arrays."""
  meta: dict
  arrays: Dict[str, np.ndarray]
  path: Optional[str] = None

  @property
  def epoch(self) -> int:
    return int(self.meta['epoch'])

  @property
  def next_start(self) -> int:
    """The first step the snapshot does not cover: the resume point, a
    chunk boundary."""
    return int(self.meta['next_start'])


def snapshot_path(directory: str, epoch: int, next_start: int) -> str:
  return os.path.join(directory, f'ckpt-{epoch:06d}-{next_start:06d}.glt')


def encode(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
  """Serialize to the self-validating byte layout."""
  buf = io.BytesIO()
  np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
  payload = buf.getvalue()
  header = json.dumps({
      'meta': _jsonify(meta),
      'payload_bytes': len(payload),
      'payload_sha256': hashlib.sha256(payload).hexdigest(),
  }, sort_keys=True).encode()
  return MAGIC + struct.pack('>I', len(header)) + header + payload


def decode(blob: bytes, label: str = 'snapshot') -> Snapshot:
  """Parse and integrity-check one encoded snapshot. Raises
  :class:`TornSnapshotError` on any mismatch."""
  if len(blob) < len(MAGIC) + 4 or blob[:len(MAGIC)] != MAGIC:
    raise TornSnapshotError(f'{label}: bad magic or truncated prologue')
  (hlen,) = struct.unpack('>I', blob[len(MAGIC):len(MAGIC) + 4])
  hstart = len(MAGIC) + 4
  if len(blob) < hstart + hlen:
    raise TornSnapshotError(f'{label}: truncated header '
                            f'({len(blob) - hstart} of {hlen} bytes)')
  try:
    header = json.loads(blob[hstart:hstart + hlen])
  except ValueError as e:
    raise TornSnapshotError(f'{label}: unparseable header: {e}') from e
  payload = blob[hstart + hlen:]
  want = int(header.get('payload_bytes', -1))
  if len(payload) != want:
    raise TornSnapshotError(
        f'{label}: payload is {len(payload)} bytes, header says {want}')
  if hashlib.sha256(payload).hexdigest() != header.get('payload_sha256'):
    raise TornSnapshotError(f'{label}: payload sha256 mismatch')
  with np.load(io.BytesIO(payload), allow_pickle=False) as z:
    arrays = {k: z[k] for k in z.files}
  return Snapshot(meta=_dejsonify(header['meta']), arrays=arrays)


def write_snapshot(directory: str, meta: dict,
                   arrays: Dict[str, np.ndarray]) -> Tuple[str, int]:
  """Atomically write one snapshot; returns ``(path, bytes)``. The
  checkpointer's writer thread and its synchronous path both write
  through here, past the ``recovery.save`` fault site."""
  fault_point('recovery.save')
  os.makedirs(directory, exist_ok=True)
  blob = encode(meta, arrays)
  path = snapshot_path(directory, int(meta['epoch']),
                       int(meta['next_start']))
  fd, tmp = tempfile.mkstemp(prefix='.ckpt-', suffix='.tmp', dir=directory)
  try:
    with os.fdopen(fd, 'wb') as fh:
      fh.write(blob)
      fh.flush()
      os.fsync(fh.fileno())
    os.replace(tmp, path)
  except BaseException:
    try:
      os.unlink(tmp)
    except OSError:
      pass
    raise
  # fsync the directory entry so the rename itself is durable
  try:
    dfd = os.open(directory, os.O_RDONLY)
    try:
      os.fsync(dfd)
    finally:
      os.close(dfd)
  except OSError:
    pass   # no directory fsync on this platform: the rename stays atomic
  return path, len(blob)


def load_snapshot(path: str) -> Snapshot:
  """Read and validate one snapshot file (the ``recovery.restore``
  fault site arms the restore-under-fault scenario)."""
  fault_point('recovery.restore')
  with open(path, 'rb') as fh:
    blob = fh.read()
  snap = decode(blob, label=os.path.basename(path))
  snap.path = path
  return snap


def list_snapshots(directory: str) -> List[Tuple[int, int, str]]:
  """``(epoch, next_start, path)`` of every snapshot file, oldest to
  newest by ``(epoch, next_start)``."""
  if not os.path.isdir(directory):
    return []
  out = []
  for name in os.listdir(directory):
    m = _NAME_RE.match(name)
    if m:
      out.append((int(m.group(1)), int(m.group(2)),
                  os.path.join(directory, name)))
  out.sort()
  return out
