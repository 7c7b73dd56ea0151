"""Training-client side of the server-client topology.

Counterpart of ``graphlearn_tpu/distributed/dist_client.py``:
``init_client`` connects to the sampling servers, ``request_server`` /
``async_request_server`` dispatch named calls, ``shutdown_client`` runs
the client barrier and (client 0) fans out the servers' exit.
"""
from typing import List, Optional, Tuple

from .dist_context import _set_client_context, get_context
from .rpc import RpcClient

_client: Optional[RpcClient] = None


def init_client(num_servers: int, num_clients: int, client_rank: int,
                server_addrs: List[Tuple[str, int]]):
  """Connect to the ``num_servers`` servers at ``server_addrs`` (the
  ``(host, port)`` pairs their ``init_server`` returned)."""
  global _client
  if len(server_addrs) != num_servers:
    raise ValueError(f'{len(server_addrs)} server addresses for '
                     f'{num_servers} servers')
  _set_client_context(num_servers, num_clients, client_rank)
  _client = RpcClient()
  for rank, (host, port) in enumerate(server_addrs):
    _client.add_target(rank, host, port)
  return _client


def get_client() -> Optional[RpcClient]:
  """The initialized RpcClient, or None."""
  return _client


def request_server(server_rank: int, func, *args, **kwargs):
  """A synchronous call of ``func`` (a name, or a ``DistServer`` method
  whose ``__name__`` is used) on server ``server_rank``."""
  name = func if isinstance(func, str) else func.__name__
  return _client.request_sync(server_rank, name, *args, **kwargs)


def async_request_server(server_rank: int, func, *args, **kwargs):
  """:func:`request_server` returning a ``Future``."""
  name = func if isinstance(func, str) else func.__name__
  return _client.request_async(server_rank, name, *args, **kwargs)


def barrier(timeout: float = 180.0):
  """Client-group barrier hosted by server 0."""
  ctx = get_context()
  return _client.request_sync(0, 'client_barrier', ctx.rank,
                              timeout=timeout)


def shutdown_client():
  """The client barrier, then (client 0) every server's ``exit``."""
  global _client
  if _client is None:
    return
  ctx = get_context()
  try:
    barrier()
    if ctx is not None and ctx.rank == 0:
      for rank in _client.targets:
        try:
          # DistServer.exit is idempotent, so a lost response may be
          # retried (with backoff) instead of leaving the server up
          _client.request_sync(rank, 'exit', idempotent=True)
        except (RuntimeError, ConnectionError, OSError, TimeoutError):
          pass
  finally:
    _client.close()
    _client = None
