"""Multiprocessing-queue channel: a ``multiprocessing.Queue`` of messages
(slower than the shared-memory ring, no native code)."""
import multiprocessing as mp
import queue as queue_mod

from .base import ChannelBase, QueueTimeoutError, SampleMessage


class MpChannel(ChannelBase):
  """``capacity`` messages at most in flight."""

  def __init__(self, capacity: int = 128, **kwargs):
    ctx = mp.get_context('spawn')
    self._queue = ctx.Queue(maxsize=capacity)
    self._capacity = capacity
    self._received = 0   # messages recv'd in THIS process (diagnostics)

  def send(self, msg: SampleMessage):
    self._queue.put(msg)

  def recv(self, timeout_ms: int = -1) -> SampleMessage:
    try:
      timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
      msg = self._queue.get(timeout=timeout)
    except queue_mod.Empty as e:
      raise QueueTimeoutError(
          f'mp channel recv timed out after {timeout_ms}ms '
          f'(capacity={self._capacity}, received_so_far='
          f'{self._received} in this process) — no producer put a '
          'message in the window; check producer health') from e
    self._received += 1
    return msg

  def empty(self) -> bool:
    return self._queue.empty()
