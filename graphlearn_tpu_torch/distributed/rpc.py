"""Lightweight TCP RPC for the server-client topology and the control
plane.

Counterpart of ``graphlearn_tpu/distributed/rpc.py``: a threaded socket
server with length-prefixed pickled frames, the same frame format and
the same mutual HMAC handshake byte for byte, so a port client talks to
a JAX server and the reverse. The wire carries numpy arrays and plain
Python values, never torch tensors.

TRUST MODEL: frames are deserialized with pickle, so anyone who can
connect can execute arbitrary code. The shared-secret MUTUAL HMAC
handshake removes the sharpest edge: set ``GLT_RPC_SECRET`` in the
environment (or pass ``secret=``) and every accepted connection must
answer an HMAC-SHA256 challenge before any frame is processed, and the
server must in turn answer the CLIENT's challenge before the client
deserializes a single response frame. The handshake is REQUIRED for
non-loopback binds (a routable server without a secret refuses to start
unless ``insecure=True``); loopback binds may omit it. Residual risk:
the handshake authenticates peers but does not encrypt or MAC the frames
that follow; the network boundary remains the outer wall against an
attacker who can rewrite established TCP streams.
"""
import hashlib
import hmac
import logging
import os
import pickle
import secrets as _secrets
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import metrics
from ..metrics import spans
from ..utils.faults import fault_point

logger = logging.getLogger('graphlearn_tpu_torch.rpc')

_HDR = struct.Struct('<Q')
_SECRET_ENV = 'GLT_RPC_SECRET'

# Typed wire errors: a server-side exception whose class carries a
# WIRE_TYPE registered in this table ships as a STRUCTURED
# ``(etype, payload-dict)`` pair in the error frame — plain primitives,
# never a pickled exception object — and the client reconstructs the
# typed exception instead of a generic RuntimeError. Anything
# unregistered keeps the string-only error path.
_WIRE_ERRORS: Dict[str, Callable[[dict], BaseException]] = {}


def register_wire_error(etype: str, factory: Callable[[dict],
                                                      BaseException]):
  """Register a typed error for structured RPC propagation. The
  factory receives the server's payload dict and returns the exception
  instance to raise client-side."""
  _WIRE_ERRORS[etype] = factory


def _env_secret() -> Optional[bytes]:
  s = os.environ.get(_SECRET_ENV)
  return s.encode() if s else None


def _hmac_of(secret: bytes, nonce: bytes,
             role: bytes = b'client') -> bytes:
  # role domain-separates the two handshake directions: without it a
  # MITM could replay one client's answer as a 'server proof' to
  # another client (reflection), never knowing the secret
  return hmac.new(secret, role + nonce, hashlib.sha256).digest()


def _send_frame(sock: socket.socket, obj: Any):
  payload = pickle.dumps(obj, protocol=5)
  # the same bytes as one length-prefixed frame, without copying the
  # payload into a concatenation
  sock.sendall(_HDR.pack(len(payload)))
  sock.sendall(payload)


# frames up to this size are read into one buffer allocated up front; a
# larger length (a garbled header, e.g. a handshake nonce read as one) is
# read in chunks as they come, allocating nothing ahead of the data
_PREALLOC_MAX = 1 << 32


def _recv_exact(sock: socket.socket, n: int):
  if n > _PREALLOC_MAX:
    chunks = []
    while n:
      b = sock.recv(min(n, 1 << 20))
      if not b:
        raise ConnectionError('peer closed')
      chunks.append(b)
      n -= len(b)
    return b''.join(chunks)
  buf = bytearray(n)
  view = memoryview(buf)
  got = 0
  while got < n:
    k = sock.recv_into(view[got:], min(n - got, 1 << 24))
    if not k:
      raise ConnectionError('peer closed')
    got += k
  return buf


def _recv_frame(sock: socket.socket) -> Any:
  (size,) = _HDR.unpack(_recv_exact(sock, 8))
  return pickle.loads(_recv_exact(sock, size))


class RpcCalleeBase:
  """Stateful remote-callable object."""

  def call(self, *args, **kwargs):
    raise NotImplementedError


class RpcServer:
  """Threaded socket server dispatching registered callees."""

  def __init__(self, host: str = '127.0.0.1', port: int = 0,
               handlers: Optional[Dict[str, Callable]] = None,
               secret: Optional[bytes] = None, insecure: bool = False):
    # handlers passed here are registered BEFORE the server starts
    # accepting — register() after construction races incoming requests
    self._handlers: Dict[str, Callable] = dict(handlers) if handlers \
        else {}
    self._secret = secret if secret is not None else _env_secret()
    loopback = host in ('127.0.0.1', 'localhost', '::1')
    if self._secret is None and not loopback and not insecure:
      raise ValueError(
          f'RpcServer binding routable address {host!r} without a '
          f'shared secret: set {_SECRET_ENV} (or pass secret=) so peers '
          'must pass the HMAC handshake, or pass insecure=True to '
          'accept unauthenticated pickle RPC on this network')
    # the accepted connections, closed by shutdown() so that no handler
    # thread outlives the server holding its callees (and through them
    # the state they own: a DistServer's dataset, shared with its
    # workers over CUDA IPC, must be freed before the process ends)
    self._conns = set()
    self._conns_lock = threading.Lock()
    outer = self

    class Handler(socketserver.BaseRequestHandler):
      def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with outer._conns_lock:
          outer._conns.add(sock)
        try:
          if outer._secret is not None:
            # mutual challenge-response BEFORE any pickle leaves the
            # wire: an unauthenticated peer never reaches the
            # deserializer, and the client hears our proof before it
            # deserializes our first response frame
            nonce = _secrets.token_bytes(32)
            sock.sendall(nonce)
            # verify the 32-byte answer BEFORE reading the client's
            # nonce: a secret-less client's first (pickle) frame can be
            # shorter than 64 bytes, and blocking on all 64 would
            # deadlock both sides instead of rejecting promptly
            answer = _recv_exact(sock, 32)
            if not hmac.compare_digest(
                answer, _hmac_of(outer._secret, nonce)):
              logger.warning('rejected RPC connection from %s: bad '
                             'HMAC handshake', self.client_address)
              return
            client_nonce = _recv_exact(sock, 32)
            sock.sendall(_hmac_of(outer._secret, client_nonce,
                                  role=b'server'))
          while True:
            req = _recv_frame(sock)
            # armed 'delay' simulates a hung server (liveness-test
            # territory); 'raise' tears the connection down mid-stream
            fault_point('rpc.server.dispatch')
            # adopt the caller's span context for the handler: spans it
            # opens (and anything it propagates onward — mp producer
            # commands, serving submits) join the caller's trace, so
            # one request id recovers the whole cross-process tree
            ctx = req.get('ctx')
            try:
              with spans.adopt(ctx), \
                  spans.span('rpc.server.handle', func=req['func']):
                fn = outer._handlers[req['func']]
                result = fn(*req.get('args', ()), **req.get('kwargs', {}))
              _send_frame(sock, {'ok': True, 'result': result})
              # a thread waiting for the next request holds no callee
              # and no result
              del fn, result
            except Exception as e:  # noqa: BLE001 - errors cross the wire
              reply = {'ok': False,
                       'error': f'{type(e).__name__}: {e}'}
              # typed rejections (tenancy throttles/quotas) ship a
              # structured payload so the client reconstructs the
              # exact exception — see register_wire_error
              etype = getattr(type(e), 'WIRE_TYPE', None)
              if etype in _WIRE_ERRORS:
                to_wire = getattr(e, 'to_wire', None)
                reply['etype'] = etype
                reply['payload'] = to_wire() if to_wire else {}
              _send_frame(sock, reply)
        except (ConnectionError, EOFError, OSError):
          pass
        finally:
          with outer._conns_lock:
            outer._conns.discard(sock)

    class Server(socketserver.ThreadingTCPServer):
      daemon_threads = True
      allow_reuse_address = True

    self._server = Server((host, port), Handler)
    self.host, self.port = self._server.server_address
    self._thread = threading.Thread(target=self._server.serve_forever,
                                    daemon=True)
    self._thread.start()

  def register(self, name: str, fn: Callable):
    """Register ``fn`` under ``name`` (before clients call it)."""
    if name in self._handlers:
      raise ValueError(f'handler {name!r} already registered')
    self._handlers[name] = fn

  def register_callee(self, name: str, callee: RpcCalleeBase):
    self.register(name, callee.call)

  def shutdown(self):
    """Stop accepting, close every live connection (their handler
    threads end) and drop the callees."""
    self._server.shutdown()
    self._server.server_close()
    with self._conns_lock:
      conns = list(self._conns)
    for sock in conns:
      try:
        sock.shutdown(socket.SHUT_RDWR)
      except OSError:
        pass
    self._handlers.clear()


class RpcClient:
  """Per-target connection pool + sync/async requests."""

  def __init__(self, max_workers: int = 8,
               secret: Optional[bytes] = None):
    self._pool = ThreadPoolExecutor(max_workers=max_workers)
    self._local = threading.local()
    self._addrs: Dict[int, Tuple[str, int]] = {}
    self._secret = secret if secret is not None else _env_secret()

  def add_target(self, rank: int, host: str, port: int):
    self._addrs[rank] = (host, port)

  @property
  def targets(self) -> List[int]:
    return sorted(self._addrs)

  def _conn(self, rank: int,
            connect_timeout: Optional[float] = None) -> socket.socket:
    conns = getattr(self._local, 'conns', None)
    if conns is None:
      conns = self._local.conns = {}
    if rank not in conns:
      # the caller's per-request timeout must bound the CONNECT too: a
      # blackholed peer (partition, no RST) would otherwise stall every
      # reconnecting probe for the full 180 s default, defeating the
      # heartbeat's seconds-scale detection promise
      s = socket.create_connection(self._addrs[rank],
                                   timeout=connect_timeout or 180)
      s.settimeout(180)   # per-request timeouts are applied in _attempt
      s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      if self._secret is not None:
        # answer the server's HMAC challenge, then verify the server's
        # answer to OURS before any response frame is unpickled (see
        # module trust model). Short timeout on the nonce read: a
        # secret-less server sends no challenge, and without this the
        # config mismatch would hang for the full 180 s socket timeout
        # with a generic error. The caller's connect budget bounds the
        # handshake too — a heartbeat probe must not wait 10 s on a
        # wedged-but-accepting peer.
        s.settimeout(min(10, connect_timeout) if connect_timeout
                     else 10)
        try:
          nonce = _recv_exact(s, 32)
          my_nonce = _secrets.token_bytes(32)
          s.sendall(_hmac_of(self._secret, nonce) + my_nonce)
          proof = _recv_exact(s, 32)
        except socket.timeout:
          s.close()
          raise ConnectionError(
              'server did not complete the mutual HMAC handshake '
              'within 10s — secret configured on this client (via '
              f'{_SECRET_ENV} or secret=) but probably not on the '
              'server') from None
        except (ConnectionError, OSError):
          # e.g. the server rejected OUR answer (secret mismatch) and
          # closed mid-handshake; don't leak the half-open socket
          s.close()
          raise
        if not hmac.compare_digest(
            proof, _hmac_of(self._secret, my_nonce, role=b'server')):
          s.close()
          raise ConnectionError(
              'server failed the mutual HMAC handshake: it does not '
              'know the shared secret — refusing to deserialize its '
              'responses')
        s.settimeout(180)
      conns[rank] = s
    return conns[rank]

  def _drop_conn(self, rank: int):
    conns = getattr(self._local, 'conns', None)
    if conns and rank in conns:
      try:
        conns.pop(rank).close()
      except OSError:
        pass

  def _attempt(self, rank: int, func: str, args, kwargs,
               timeout: Optional[float]):
    """One request/response round trip on the pooled connection."""
    t0 = time.perf_counter()
    # one client span per round trip, carrying the current trace (or
    # this process's run_id) over the wire in the frame's ctx field —
    # the server adopts it for the handler, so client and server spans
    # of one request join on the same id
    sp = spans.begin('rpc.client.request', rank=rank, func=func)
    # the span closes in ONE place (the finally) so no raise can leak
    # it; each path records its outcome by rebinding end_kw first
    end_kw = {'ok': False, 'error': 'client'}
    try:
      try:
        fault_point('rpc.client.request')
        sock = self._conn(rank, connect_timeout=timeout)
        if timeout is not None:
          sock.settimeout(timeout)
        _send_frame(sock, {'func': func, 'args': args, 'kwargs': kwargs,
                           'ctx': {'trace': sp.trace,
                                   'span': sp.span_id}})
        resp = _recv_frame(sock)
        fault_point('rpc.client.response')
        if timeout is not None:
          sock.settimeout(180)
      except socket.timeout as e:
        # normalize to TimeoutError so retry_on and callers see one type
        end_kw = {'ok': False, 'error': 'timeout'}
        self._drop_conn(rank)
        raise TimeoutError(
            f'rpc to rank {rank} func {func!r} timed out after '
            f'{timeout}s') from e
      except BaseException as e:
        end_kw = {'ok': False, 'error': type(e).__name__}
        # a broken pooled connection must not poison the next attempt
        if isinstance(e, (ConnectionError, EOFError, OSError)):
          self._drop_conn(rank)
        raise
      if not resp['ok']:
        end_kw = {'ok': False, 'error': 'remote'}
        factory = _WIRE_ERRORS.get(resp.get('etype'))
        if factory is not None:
          # typed rejection: reconstruct it so callers can distinguish
          # a retryable throttle from a remote fault
          end_kw = {'ok': False, 'error': str(resp.get('etype'))}
          raise factory(resp.get('payload') or {})
        raise RuntimeError(
            f'remote error from rank {rank}: {resp["error"]}')
      end_kw = {'ok': True}
      # successful round trips feed the request latency histogram
      metrics.observe('rpc.client.request_ms',
                      (time.perf_counter() - t0) * 1e3)
      return resp['result']
    finally:
      spans.end(sp, **end_kw)

  def request_sync(self, rank: int, func: str, *args,
                   timeout: Optional[float] = None,
                   idempotent: bool = False,
                   retry_policy=None, **kwargs):
    """One named call, answered synchronously.

    ``timeout`` bounds each attempt (socket-level, seconds). Failed
    attempts are
    retried — with exponential backoff + jitter under ``retry_policy``
    (default resilience.DEFAULT_RETRY_POLICY) — ONLY when the caller
    declares the callee ``idempotent=True``: a retry after a lost
    response re-executes the remote side effect, so non-idempotent
    calls get exactly one attempt and surface the first error.
    """
    from .resilience import DEFAULT_RETRY_POLICY, NO_RETRY
    if retry_policy is not None and not idempotent:
      raise ValueError(
          f'retry_policy passed for rpc {func!r} without idempotent=True '
          '— retrying a non-idempotent call can duplicate its side '
          'effect; declare the callee idempotent to opt into retry')
    policy = (retry_policy or DEFAULT_RETRY_POLICY) if idempotent \
        else NO_RETRY
    if timeout is None:
      timeout = policy.per_attempt_timeout
    return policy.run(
        self._attempt, rank, func, args, kwargs, timeout,
        retry_on=(ConnectionError, TimeoutError, OSError, EOFError),
        describe=f'rpc to rank {rank} func {func!r}')

  def request_async(self, rank: int, func: str, *args, **kwargs) -> Future:
    """:meth:`request_sync` on the client's thread pool."""
    return self._pool.submit(self.request_sync, rank, func, *args,
                             **kwargs)

  def close(self):
    self._pool.shutdown(wait=False)
    conns = getattr(self._local, 'conns', {})
    for s in conns.values():
      try:
        s.close()
      except OSError:
        pass


class RpcDataPartitionRouter:
  """Round-robin workers serving each data partition."""

  def __init__(self, partition_to_workers: Dict[int, List[int]]):
    self._p2w = partition_to_workers
    self._next = {p: 0 for p in partition_to_workers}

  def get_to_worker(self, partition: int) -> int:
    workers = self._p2w[partition]
    i = self._next[partition]
    self._next[partition] = (i + 1) % len(workers)
    return workers[i]


class Barrier:
  """Server-hosted counting barrier."""

  def __init__(self, world_size: int):
    self._world = world_size
    self._count = 0
    self._gen = 0
    self._cv = threading.Condition()
    self._values: Dict[int, Any] = {}
    self._arrived = set()

  def arrive(self, rank: int, value: Any = None, timeout: float = 180.0,
             phase: Optional[int] = None):
    """``phase`` (optional, monotonically increasing per caller) makes
    retries fully idempotent: a retry of an ALREADY-RELEASED phase
    returns immediately instead of being miscounted into the next
    generation (a retry can arrive late when only the response was
    lost)."""
    with self._cv:
      gen = self._gen
      if phase is not None and phase < gen:
        return dict(self._values)   # stale retry of a released phase
      if rank in self._arrived:
        # duplicate arrival within a generation (client retried after a
        # lost response): wait for the release, don't double-count
        if not self._cv.wait_for(lambda: self._gen > gen,
                                 timeout=timeout):
          raise TimeoutError('barrier timeout')
        return dict(self._values)
      self._arrived.add(rank)
      self._values[rank] = value
      self._count += 1
      if self._count == self._world:
        self._count = 0
        self._arrived.clear()
        self._gen += 1
        self._cv.notify_all()
      else:
        if not self._cv.wait_for(lambda: self._gen > gen,
                                 timeout=timeout):
          raise TimeoutError('barrier timeout')
      return dict(self._values)


def get_free_port(host: str = '127.0.0.1') -> int:
  with socket.socket() as s:
    s.bind((host, 0))
    return s.getsockname()[1]
