"""Client-side receiving channel pulling batches from sampling servers.

Counterpart of ``graphlearn_tpu/channel/remote_channel.py``: keeps
``prefetch_size`` outstanding fetch requests per (server, producer)
pair, buffers responses in a local queue, and tracks the per-server
end-of-epoch protocol (a ``None`` message with the end flag).

Resilience (``distributed/resilience.py`` is the companion):

* every message carries provenance — ``recv_with_meta`` returns
  ``(rank, producer_id, msg)`` so the loader can ack which server
  delivered which seeds;
* a fetch failure marks the (server, producer) pair FAILED: one
  :class:`PeerDeadError` surfaces through ``recv`` (sibling pullers of
  the pair exit quietly) and the pair stops counting toward epoch
  completion, leaving the caller free to fail over;
* ``add_producer`` attaches a replacement producer mid-epoch (failover
  target) and ``abandon`` drops a pair so a hung-then-recovered server
  cannot leak late duplicates into the stream.

Fetches are NOT blindly retried here: ``fetch_one_sampled_message``
dequeues server-side, so a re-sent fetch after a lost response would
lose a batch silently. Lost-in-flight batches are instead recovered by
the loader's seed-level failover (unacked seeds are re-requested).
"""
import queue
import threading
from typing import List, Tuple

from ..utils.faults import fault_point
from .base import ChannelBase, QueueTimeoutError, SampleMessage


class PeerDeadError(RuntimeError):
  """A (server, producer) pair failed mid-epoch; carries provenance."""

  def __init__(self, rank: int, producer_id: int, cause: str):
    super().__init__(f'fetch from server rank {rank} '
                     f'(producer {producer_id}) failed: {cause}')
    self.rank = rank
    self.producer_id = producer_id
    self.cause = cause


class RemoteReceivingChannel(ChannelBase):
  """Pulls each (server rank, producer id) pair's batches into one
  local queue."""

  def __init__(self, server_ranks: List[int], producer_ids: List[int],
               prefetch_size: int = 4, request_fn=None):
    """`request_fn(server_rank, producer_id)` -> (msg|None, end_flag);
    defaults to dist_client.request_server(fetch_one_sampled_message)
    with a bounded per-request timeout (the server's fetch poll returns
    within ~its timeout_ms, so a fetch blocked for longer means a hung
    peer, not a slow epoch)."""
    self.server_ranks = list(server_ranks)
    self.producer_ids = list(producer_ids)
    self.prefetch_size = prefetch_size
    if request_fn is None:
      from ..distributed import dist_client

      def request_fn(rank, pid):
        return dist_client.request_server(
            rank, 'fetch_one_sampled_message', pid, timeout=30.0)
    self._request_fn = request_fn
    self._queue: queue.Queue = queue.Queue()
    self._threads: List[threading.Thread] = []
    self._stopped = threading.Event()
    self._lock = threading.Lock()
    self._started = False
    self._pairs = set()        # pairs participating in THIS epoch
    self._ends_seen = set()
    self._failed = set()       # pairs that died or were abandoned
    self._received = 0

  def _puller(self, rank: int, pid: int, q: queue.Queue, active: dict,
              stopped: threading.Event, failed: set):
    """One puller thread per (producer, prefetch slot).

    End-of-epoch ordering: with prefetch_size > 1 several pullers fetch the
    same producer concurrently, so the thread that receives the (None, end)
    response may finish while a sibling still has an earlier message in
    flight. The producer's 'end' marker is therefore only enqueued by the
    LAST puller of that producer to exit — every sibling has enqueued its
    final message before then, so no batch can be dropped behind the
    marker.

    Failure: the FIRST puller whose fetch raises marks the pair failed
    and enqueues one 'dead' marker; siblings (whose own fetches will
    fail, or who see the failed flag) exit without enqueuing anything
    more for the pair. A pair in ``failed`` (also set by abandon())
    never enqueues another message — a hung server that recovers after
    failover cannot leak duplicate batches into the epoch.

    ``q``/``active``/``stopped``/``failed`` are THIS epoch's objects,
    passed in rather than read from self: a puller that outlives its
    epoch (consumer abandoned it mid-stream, then start() began a new
    one) keeps writing to its own epoch's dead queue and can never
    poison a later epoch's state.
    """
    try:
      while not stopped.is_set():
        with self._lock:
          if (rank, pid) in failed:
            return
        try:
          fault_point('channel.remote.fetch')
          msg, end = self._request_fn(rank, pid)
        except Exception as e:  # noqa: BLE001 - surfaced to the consumer
          # failed.add and the 'dead' enqueue must be atomic: the
          # consumer's completion check reads (failed, queue-empty)
          # under this lock, and a gap between the two would let it
          # declare the epoch complete without ever surfacing the
          # PeerDeadError that triggers failover
          with self._lock:
            if (rank, pid) not in failed:
              failed.add((rank, pid))
              q.put(('dead', (rank, pid, repr(e))))
          return
        # the failed-check and the enqueue must be atomic: abandon()
        # takes the same lock before the caller drains the queue, so a
        # message is either visible to that drain or discarded — never
        # enqueued after the drain computed its unacked set (which
        # would deliver the batch twice once failover replays it)
        with self._lock:
          if (rank, pid) in failed:
            return   # late response after abandon/failover: discard
          if msg is not None:
            q.put(('msg', (rank, pid, msg)))
        if end:
          return
    finally:
      with self._lock:
        active[(rank, pid)] -= 1
        last = active[(rank, pid)] == 0
      if last:
        q.put(('end', (rank, pid)))

  def start(self):
    """Begin one epoch of pulling.

    Any previous epoch's pullers are stopped AND joined first: a stale
    puller that survived into the new epoch would consume new-epoch
    messages into its retired queue (the server counts them toward
    expected, so the new epoch would silently come up short). Callers
    restarting server producers must do so AFTER the old pullers are dead
    — see RemoteDistNeighborLoader.__iter__ ordering.
    """
    self.start_pairs(list(zip(self.server_ranks, self.producer_ids)))

  def start_pairs(self, pairs: List[Tuple[int, int]]):
    """start() restricted to a subset of the configured (rank, producer)
    pairs — loaders exclude ranks already known dead."""
    self.stop(join=True)
    self._stopped = threading.Event()
    self._queue = queue.Queue()
    self._received = 0
    with self._lock:
      self._threads = []
      self._active = {}
      self._pairs = set(pairs)
      self._failed = set()
      # one end-marker per (server, producer) pair ends the epoch
      self._ends_seen = set()
    for rank, pid in pairs:
      self._spawn_pullers(rank, pid)
    self._started = True

  def _spawn_pullers(self, rank: int, pid: int):
    threads = []
    with self._lock:
      self._active[(rank, pid)] = self.prefetch_size
      for _ in range(self.prefetch_size):
        t = threading.Thread(
            target=self._puller,
            args=(rank, pid, self._queue, self._active, self._stopped,
                  self._failed),
            daemon=True)
        self._threads.append(t)
        threads.append(t)
    for t in threads:
      t.start()

  def add_producer(self, rank: int, pid: int):
    """Attach a replacement producer mid-epoch (failover target): it
    joins this epoch's completion accounting and gets its own pullers.
    The caller must have started the producer's epoch server-side
    first."""
    with self._lock:
      if (rank, pid) in self._pairs:
        return
      self._pairs.add((rank, pid))
    self._spawn_pullers(rank, pid)

  def abandon(self, rank: int, pid: int):
    """Stop pulling from a pair and drop any of its late responses.
    Its pullers exit at the next loop; an in-flight fetch result is
    discarded. The pair stops counting toward epoch completion."""
    with self._lock:
      self._failed.add((rank, pid))

  def recv(self, timeout_ms: int = -1) -> SampleMessage:
    return self.recv_with_meta(timeout_ms)[2]

  def recv_with_meta(self, timeout_ms: int = -1
                     ) -> Tuple[int, int, SampleMessage]:
    """Next message as ``(server_rank, producer_id, msg)``.

    Raises :class:`PeerDeadError` ONCE per failed pair (the caller
    decides whether to fail over via ``add_producer`` or give up),
    :class:`QueueTimeoutError` on an empty window, and StopIteration
    when every live pair has delivered its end marker.
    """
    if not self._started:
      self.start()
    timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
    while True:
      # completion check up front: every pair accounted for (ended or
      # failed-and-handled) and nothing buffered -> epoch complete
      with self._lock:
        done = self._started and \
            self._ends_seen | self._failed >= self._pairs and \
            self._queue.empty()
      if done:
        self._started = False
        raise StopIteration('epoch complete')
      try:
        kind, payload = self._queue.get(timeout=timeout)
      except queue.Empty as e:
        with self._lock:
          n_live = len(self._pairs - self._failed)
          n_done = len(self._ends_seen)
          got = self._received
        raise QueueTimeoutError(
            f'remote channel recv timed out after {timeout_ms}ms '
            f'(servers={sorted(set(self.server_ranks))}, live_pairs='
            f'{n_live}, ended={n_done}, received_so_far={got}) — no '
            'sampling server delivered a batch in the window; check '
            'server liveness') from e
      if kind == 'msg':
        rank, pid, msg = payload
        self._received += 1
        return rank, pid, msg
      if kind == 'dead':
        rank, pid, cause = payload
        raise PeerDeadError(rank, pid, cause)
      if kind == 'end':
        with self._lock:
          self._ends_seen.add(payload)
          if self._ends_seen | self._failed >= self._pairs:
            self._started = False
            raise StopIteration('epoch complete')

  def drain_now(self):
    """Yield every already-buffered (rank, pid, msg) without blocking;
    'end' markers are accounted, 'dead' markers are left queued for the
    next recv. Failover uses this to ack in-flight batches from a dying
    server BEFORE computing its unacked seed set."""
    out = []
    requeue = []
    while True:
      try:
        kind, payload = self._queue.get_nowait()
      except queue.Empty:
        break
      if kind == 'msg':
        self._received += 1
        out.append(payload)
      elif kind == 'end':
        with self._lock:
          self._ends_seen.add(payload)
      else:
        requeue.append((kind, payload))
    for item in requeue:
      self._queue.put(item)
    return out

  def empty(self) -> bool:
    return self._queue.empty()

  def stop(self, join: bool = False, timeout: float = 30.0):
    """Signal pullers to wind down; with ``join`` wait for them to exit
    (each finishes at most one in-flight request)."""
    self._stopped.set()
    if join:
      for t in self._threads:
        t.join(timeout=timeout)
      self._threads = []
    self._started = False
