"""Concurrent event loop: a daemon-thread asyncio loop with bounded
concurrency (counterpart of ``graphlearn_tpu/distributed/event_loop.py``:
``add_task`` with a callback, ``run_task`` synchronously, a semaphore
cap)."""
import asyncio
import threading
import time
from typing import Callable, Optional


class ConcurrentEventLoop:
  """An asyncio loop on its own daemon thread, at most ``concurrency``
  tasks at once."""

  def __init__(self, concurrency: int = 4):
    self._loop = asyncio.new_event_loop()
    self._sem = None
    self._concurrency = concurrency
    self._thread = threading.Thread(target=self._run, daemon=True)

  def _run(self):
    asyncio.set_event_loop(self._loop)
    self._sem = asyncio.BoundedSemaphore(self._concurrency)
    self._loop.run_forever()

  def start_loop(self):
    if not self._thread.is_alive():
      self._thread.start()
      while self._sem is None:
        time.sleep(0.001)  # until the loop thread made its semaphore

  def shutdown_loop(self):
    if self._thread.is_alive():
      self._loop.call_soon_threadsafe(self._loop.stop)
      self._thread.join(timeout=5)

  def add_task(self, coro, callback: Optional[Callable] = None):
    """Schedule `coro` under the concurrency cap; `callback(result)` fires
    on completion."""

    async def guarded():
      async with self._sem:
        return await coro

    fut = asyncio.run_coroutine_threadsafe(guarded(), self._loop)
    if callback is not None:
      fut.add_done_callback(lambda f: callback(f.result()))
    return fut

  def run_task(self, coro):
    """Run `coro` to completion synchronously."""
    return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

  async def wrap_future(self, fut):
    """concurrent.futures.Future -> awaitable."""
    return await asyncio.wrap_future(fut, loop=self._loop)
