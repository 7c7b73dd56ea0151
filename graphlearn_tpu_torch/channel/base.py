"""Channel interface and the ``SampleMessage`` wire format.

A ``SampleMessage`` is a flat ``Dict[str, np.ndarray]`` with '#' control
keys; serialization packs it into one contiguous buffer, the layout of
``graphlearn_tpu/channel/base.py`` byte for byte (a message serialized
by either package deserializes in the other). Deserialization views the
arrays over the received buffer.
"""
import struct
from typing import Dict

import numpy as np

# A flat dict of host arrays, with '#' control keys ('#META.*').
SampleMessage = Dict[str, np.ndarray]

_MAGIC = 0x474C5431  # 'GLT1'


def _layout(msg: SampleMessage):
  """``(total bytes, [(header bytes, contiguous array)])`` of the
  serialized message."""
  parts = []
  offset = 8
  for key, arr in msg.items():
    arr = np.ascontiguousarray(arr)
    kb = key.encode()
    db = arr.dtype.str.encode()
    hdr = struct.pack('<H', len(kb)) + kb + struct.pack('<B', len(db)) + db
    hdr += struct.pack('<B', arr.ndim)
    hdr += struct.pack(f'<{arr.ndim}q', *arr.shape) if arr.ndim else b''
    hdr += struct.pack('<Q', arr.nbytes)
    hdr += b'\x00' * ((-(offset + len(hdr))) % 8)  # align the data region
    parts.append((hdr, arr))
    offset += len(hdr) + arr.nbytes
  return offset, parts


def serialize_into(msg: SampleMessage) -> bytearray:
  """:func:`serialize_message` into one buffer, each array copied once."""
  total, parts = _layout(msg)
  buf = bytearray(total)
  mv = memoryview(buf)
  struct.pack_into('<II', buf, 0, _MAGIC, len(msg))
  off = 8
  for hdr, arr in parts:
    mv[off:off + len(hdr)] = hdr
    off += len(hdr)
    n = arr.nbytes
    if n:
      mv[off:off + n] = memoryview(arr.reshape(-1)).cast('B')
    off += n
  return buf


def serialize_message(msg: SampleMessage) -> bytes:
  """Pack to: magic u32, count u32, then per tensor:
  key_len u16 | key | dtype_len u8 | dtype | ndim u8 | dims i64* | nbytes
  u64 | raw data (8-aligned)."""
  return bytes(serialize_into(msg))


def deserialize_message(buf) -> SampleMessage:
  """Inverse of :func:`serialize_message`; arrays are views over ``buf``
  where alignment allows."""
  mv = memoryview(buf)
  magic, count = struct.unpack_from('<II', mv, 0)
  if magic != _MAGIC:
    raise ValueError('corrupt sample message')
  off = 8
  out: SampleMessage = {}
  for _ in range(count):
    (klen,) = struct.unpack_from('<H', mv, off)
    off += 2
    key = bytes(mv[off:off + klen]).decode()
    off += klen
    (dlen,) = struct.unpack_from('<B', mv, off)
    off += 1
    dtype = np.dtype(bytes(mv[off:off + dlen]).decode())
    off += dlen
    (ndim,) = struct.unpack_from('<B', mv, off)
    off += 1
    shape = struct.unpack_from(f'<{ndim}q', mv, off) if ndim else ()
    off += 8 * ndim
    (nbytes,) = struct.unpack_from('<Q', mv, off)
    off += 8
    off += (-off) % 8  # skip the writer's data-alignment pad
    arr = np.frombuffer(mv, dtype=dtype, count=nbytes // dtype.itemsize,
                        offset=off).reshape(shape)
    off += nbytes
    out[key] = arr
  return out


class QueueTimeoutError(RuntimeError):
  """A channel's recv found nothing in its window.

  When the stalled stream belongs to a known tenant, :meth:`with_context`
  stamps the tenant id and its last-seen quota snapshot onto the error,
  so a starved tenant's timeout names who hit what limit.
  """

  tenant: str = None
  quota: dict = None

  def with_context(self, tenant=None, quota=None) -> 'QueueTimeoutError':
    """Attach tenant/quota context and fold it into the message."""
    self.tenant = tenant
    self.quota = dict(quota) if quota else None
    parts = []
    if tenant is not None:
      parts.append(f'tenant={tenant!r}')
    if self.quota:
      parts.append(f'quota={self.quota}')
    if parts and self.args:
      self.args = (f'{self.args[0]} [{", ".join(parts)}]',) + self.args[1:]
    elif parts:
      self.args = (f'[{", ".join(parts)}]',)
    return self


class ChannelBase:
  """send / recv / empty."""

  def send(self, msg: SampleMessage):
    raise NotImplementedError

  def recv(self, timeout_ms: int = -1) -> SampleMessage:
    raise NotImplementedError

  def empty(self) -> bool:
    raise NotImplementedError
