"""Shared-memory channel over the native ring queue.

Counterpart of ``graphlearn_tpu/channel/shm_channel.py``: the ring of
``csrc/shm_queue.cc`` (built by ``utils.build``) with message
(de)serialization, timeout recv, and pickling by shmid (a spawned
process attaches to the same ring). The ring is marked for removal when
it is made, so it dies with the last process attached to it: a crashed
owner leaves no segment behind. ``pin_memory`` is accepted as in JAX:
the batch's one device-to-host copy goes into pinned memory on the
producer's side, before ``send``.
"""
import ctypes
import threading
import weakref
from typing import Optional

import numpy as np

from ..utils.faults import fault_point
from .base import (ChannelBase, QueueTimeoutError, SampleMessage,
                   deserialize_message, serialize_into)

# ShmChannels open in THIS process (weak: a collected channel drops out
# even if close() was never called). Tests hold it back at its baseline.
_live_channels: 'weakref.WeakSet' = weakref.WeakSet()


def live_channel_count() -> int:
  """Number of open (not yet close()d) ShmChannels in this process."""
  return sum(1 for c in _live_channels if c._q)


class ShmChannel(ChannelBase):
  """A byte-bounded ring of ``shm_size`` bytes (default 64 MiB). A
  message larger than the ring raises in :meth:`send`."""

  def __init__(self, capacity: Optional[int] = None,
               shm_size: Optional[int] = None, pin_memory: bool = False,
               _shmid: Optional[int] = None):
    from ..utils.build import load_native
    self._lib = load_native()
    del capacity  # the ring is byte-bounded; its block count is implicit
    self.shm_size = shm_size or (1 << 26)
    self.pin_memory = pin_memory
    if _shmid is not None:
      self._q = self._lib.shmq_attach(_shmid)
      if not self._q:
        raise RuntimeError(f'shmq_attach({_shmid}) failed')
    else:
      self._q = self._lib.shmq_create(self.shm_size)
      if not self._q:
        raise RuntimeError(f'shmq_create({self.shm_size}) failed')
    # recv is a peek(size)-then-dequeue pair in two native critical
    # sections: concurrent recv callers in one process (the server's
    # RPC handler threads) serialize the pair here
    self._recv_lock = threading.Lock()
    self._received = 0   # messages recv'd in THIS process (diagnostics)
    _live_channels.add(self)

  @property
  def shmid(self) -> int:
    return self._lib.shmq_id(self._q)

  def send(self, msg: SampleMessage):
    if fault_point('channel.shm.send') == 'drop':
      return   # injected message loss: consumers must survive a gap
    buf = serialize_into(msg)
    rc = self._lib.shmq_enqueue(
        self._q, (ctypes.c_char * len(buf)).from_buffer(buf), len(buf))
    if rc != 0:
      raise RuntimeError(
          f'message of {len(buf)} bytes exceeds ring capacity '
          f'{self.shm_size}')

  def _timeout(self, timeout_ms: int) -> QueueTimeoutError:
    return QueueTimeoutError(
        f'shm channel recv timed out after {timeout_ms}ms '
        f'(shmid={self.shmid}, ring={self.shm_size} bytes, '
        f'received_so_far={self._received} in this process) — producers '
        'sent nothing in the window; check producer worker health')

  def recv(self, timeout_ms: int = -1) -> SampleMessage:
    with self._recv_lock:
      size = self._lib.shmq_next_size(self._q, timeout_ms)
      if size == -1:
        raise self._timeout(timeout_ms)
      if size == -2:
        raise StopIteration('channel finished')
      # an uninitialised buffer: the dequeue writes every byte of it
      buf = np.empty(size, np.uint8)
      got = self._lib.shmq_dequeue(self._q, buf.ctypes.data, size,
                                   timeout_ms)
      if got == -1:
        raise self._timeout(timeout_ms)
      if got == -2:
        raise StopIteration('channel finished')
      if got != size:
        raise RuntimeError(f'shm ring gave {got} bytes for a block of '
                           f'{size}')
      self._received += 1
    # the arrays view the dequeued buffer (no further copy)
    return deserialize_message(buf)

  def empty(self) -> bool:
    return self._lib.shmq_count(self._q) == 0

  def finish(self):
    """Producer end-of-epoch mark (end-of-stream protocol)."""
    self._lib.shmq_finish(self._q)

  def reset(self):
    self._lib.shmq_reset_finished(self._q)

  def close(self):
    if self._q:
      self._lib.shmq_close(self._q)
      self._q = None

  # pickled by shmid: a consumer process attaches to the same ring
  def __reduce__(self):
    return (ShmChannel, (None, self.shm_size, self.pin_memory, self.shmid))
