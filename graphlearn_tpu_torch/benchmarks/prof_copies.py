"""The remote stack's host copies, the port's way against the JAX
package's (the same bytes either way), on one machine.

A full-width message (937,984 node slots of 100 float32 features and
936,960 edges: 391 MB) is written to a shared-memory ring, read back and
fetched over a loopback RPC, alternating port, JAX, JAX, port four times:

- ring write: the port serializes into one buffer (one copy an array);
  JAX's ``serialize_message`` copies each array out (``tobytes``) and
  joins them (two copies); the enqueue's copy into the ring follows both.
- ring read: the port dequeues into an uninitialised numpy buffer that
  the arrays view; JAX dequeues into a zero-filled ctypes buffer and
  copies it into ``bytes``.
- wire: the port sends the frame's header and payload apart and reads
  the frame into one buffer allocated up front; JAX concatenates header
  and payload and joins 1 MiB chunks.

Run: ``python -m graphlearn_tpu_torch.benchmarks.prof_copies`` (host
only: no card needed). One JSON line: per stage and way the median, min
and max ms and each run.
"""
import ctypes
import json
import pickle
import struct
import time

import numpy as np


def message():
  rng = np.random.default_rng(0)
  n, e = 937_984, 936_960
  return {'node': rng.integers(0, 1 << 20, n).astype(np.int32),
          'num_nodes': np.array([n], np.int32),
          'row': rng.integers(0, n, e).astype(np.int32),
          'col': rng.integers(0, n, e).astype(np.int32),
          'edge_mask': np.ones(e, bool),
          'x': rng.standard_normal((n, 100), dtype=np.float32),
          'y': rng.integers(0, 47, n).astype(np.int32)}


def main():
  from graphlearn_tpu_torch.channel import ShmChannel, base
  from graphlearn_tpu_torch.distributed import rpc
  msg = message()
  size = len(base.serialize_into(msg))
  ch = ShmChannel(shm_size=2 * size + (1 << 20))
  lib = ch._lib

  def write_port():
    ch.send(msg)

  def write_jax():
    # graphlearn_tpu/channel/base.py's serialize_message: every array
    # copied out by tobytes, then the parts joined
    _, layout = base._layout(msg)
    parts = [struct.pack('<II', base._MAGIC, len(msg))]
    for hdr, arr in layout:
      parts += [hdr, arr.tobytes()]
    buf = b''.join(parts)
    lib.shmq_enqueue(ch._q, buf, len(buf))

  def read_port():
    return ch.recv(timeout_ms=10000)

  def read_jax():
    n = lib.shmq_next_size(ch._q, 10000)
    buf = ctypes.create_string_buffer(n)
    lib.shmq_dequeue(ch._q, buf, n, 10000)
    return base.deserialize_message(bytes(buf))

  port_frames = (rpc._send_frame, rpc._recv_exact)

  def jax_send(sock, obj):
    payload = pickle.dumps(obj, protocol=5)
    sock.sendall(rpc._HDR.pack(len(payload)) + payload)

  def jax_recv_exact(sock, n):
    chunks = []
    while n:
      b = sock.recv(min(n, 1 << 20))
      if not b:
        raise ConnectionError('peer closed')
      chunks.append(b)
      n -= len(b)
    return b''.join(chunks)

  server = rpc.RpcServer()
  server.register('fetch', lambda: (msg, False))
  client = rpc.RpcClient()
  client.add_target(0, server.host, server.port)

  def wire(variant):
    rpc._send_frame, rpc._recv_exact = (
        port_frames if variant == 'port' else (jax_send, jax_recv_exact))
    t0 = time.perf_counter()
    client.request_sync(0, 'fetch', timeout=120)
    return (time.perf_counter() - t0) * 1e3

  out = {k: {'port': [], 'jax': []} for k in ('write', 'read', 'wire')}
  for _ in range(4):
    for variant in ('port', 'jax', 'jax', 'port'):
      t0 = time.perf_counter()
      (write_port if variant == 'port' else write_jax)()
      t1 = time.perf_counter()
      (read_port if variant == 'port' else read_jax)()
      t2 = time.perf_counter()
      out['write'][variant].append((t1 - t0) * 1e3)
      out['read'][variant].append((t2 - t1) * 1e3)
      out['wire'][variant].append(wire(variant))
  client.close()
  server.shutdown()
  ch.close()
  summary = {k: {v: dict(median=float(np.median(x)), min=float(min(x)),
                         max=float(max(x)), runs=x)
                 for v, x in d.items()} for k, d in out.items()}
  summary['message_bytes'] = size
  print(json.dumps(summary))


if __name__ == '__main__':
  main()
