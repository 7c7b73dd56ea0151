"""Disk (cold) tier: memory-mapped row-chunk files.

Counterpart of ``graphlearn_tpu/storage/disk.py`` (the port's own numpy
code, with the same on-disk layout, so either package opens a tier the
other wrote). A DiskTier is a directory of fixed-height
row-chunk files plus a ``meta.json``; rows are addressed by their
tier-relative index and gathered through ``np.memmap`` /
``np.load(mmap_mode='r')`` views, so the host working set is the OS page
cache, not a resident copy.

Two on-disk layouts:

* ``npy``  -- one ``chunk_NNNNN.npy`` per row block (np.save /
  np.load(mmap_mode='r')), the default.
* ``raw``  -- one ``chunk_NNNNN.raw`` per row block (bare np.memmap).

Both support :meth:`DiskTier.create_empty` + :meth:`DiskTier.write_rows`,
the streaming spill path. ``rows_per_chunk`` bounds the open mmap handles
and the unit of sequential disk IO the staging worker issues; gathers
span chunk boundaries freely.
"""
import json
import os

import numpy as np

_META = 'meta.json'


def _chunk_name(i: int, fmt: str) -> str:
  return f'chunk_{i:05d}.{fmt}'


def _check_layout(fmt: str, rows_per_chunk: int):
  if fmt not in ('npy', 'raw'):
    raise ValueError(f"fmt must be 'npy' or 'raw', got {fmt!r}")
  if rows_per_chunk < 1:
    raise ValueError('rows_per_chunk must be >= 1')


def _write_meta(dir_path, rows, dim, dtype, rows_per_chunk, fmt,
                num_chunks):
  meta = dict(rows=int(rows), dim=int(dim), dtype=np.dtype(dtype).name,
              rows_per_chunk=int(rows_per_chunk), fmt=fmt,
              num_chunks=int(num_chunks))
  with open(os.path.join(dir_path, _META), 'w', encoding='utf-8') as fh:
    json.dump(meta, fh)


class DiskTier:
  """A [rows, dim] on-disk row table, gathered via memory maps.

  Open an existing tier with ``DiskTier(dir_path)``; create one from an
  in-RAM array with :meth:`write`, or streamed with
  :meth:`create_empty` + :meth:`write_rows` (raw layout only).
  """

  def __init__(self, dir_path: str):
    self.dir = str(dir_path)
    with open(os.path.join(self.dir, _META), encoding='utf-8') as fh:
      meta = json.load(fh)
    self.rows = int(meta['rows'])
    self.dim = int(meta['dim'])
    self.dtype = np.dtype(meta['dtype'])
    self.rows_per_chunk = int(meta['rows_per_chunk'])
    self.fmt = meta['fmt']
    self.num_chunks = int(meta['num_chunks'])
    self._maps = {}   # chunk index -> lazily opened mmap view

  # ------------------------------------------------------------ creation

  @classmethod
  def write(cls, dir_path: str, array, rows_per_chunk: int = 65536,
            fmt: str = 'npy') -> 'DiskTier':
    """Write ``array`` ([rows, dim]) as a chunked tier and open it."""
    array = np.asarray(array)
    if array.ndim != 2:
      raise ValueError(f'DiskTier stores [rows, dim] tables, got shape '
                       f'{array.shape}')
    _check_layout(fmt, rows_per_chunk)
    os.makedirs(dir_path, exist_ok=True)
    rows = array.shape[0]
    num_chunks = max(1, -(-rows // rows_per_chunk))
    # each chunk file written once, whole (the same bytes as
    # create_empty + write_rows, without the zero fill and the msyncs)
    for i in range(num_chunks):
      block = np.ascontiguousarray(
          array[i * rows_per_chunk:(i + 1) * rows_per_chunk])
      path = os.path.join(dir_path, _chunk_name(i, fmt))
      if fmt == 'npy':
        np.save(path, block)
      else:
        block.tofile(path)
    _write_meta(dir_path, rows, array.shape[1], array.dtype, rows_per_chunk,
                fmt, num_chunks)
    return cls(dir_path)

  @classmethod
  def create_empty(cls, dir_path: str, rows: int, dim: int, dtype,
                   rows_per_chunk: int = 65536,
                   fmt: str = 'npy') -> 'DiskTier':
    """Allocate an all-zeros tier to be filled with :meth:`write_rows`
    (the streaming spill path). Both layouts allocate their chunk files
    up front so partial writes never leave a short file behind."""
    _check_layout(fmt, rows_per_chunk)
    rows, dim = int(rows), int(dim)
    dtype = np.dtype(dtype)
    os.makedirs(dir_path, exist_ok=True)
    num_chunks = max(1, -(-rows // rows_per_chunk))
    for i in range(num_chunks):
      h = min(rows_per_chunk, rows - i * rows_per_chunk)
      h = max(h, 0)
      path = os.path.join(dir_path, _chunk_name(i, fmt))
      if fmt == 'npy':
        np.save(path, np.zeros((h, dim), dtype))
      else:
        mm = np.memmap(path, dtype=dtype, mode='w+', shape=(h, dim))
        mm.flush()
        del mm
    _write_meta(dir_path, rows, dim, dtype, rows_per_chunk, fmt, num_chunks)
    return cls(dir_path)

  def write_rows(self, start: int, block):
    """Write ``block`` at tier rows [start, start+len) (spanning chunk
    boundaries). npy chunks are rewritten via a writable mmap of the
    saved file; raw chunks through np.memmap 'r+'."""
    block = np.asarray(block, self.dtype)
    done = 0
    while done < block.shape[0]:
      row = start + done
      c, off = divmod(row, self.rows_per_chunk)
      mm = self._open(c, mode='r+')
      n = min(mm.shape[0] - off, block.shape[0] - done)
      if n <= 0:
        raise IndexError(f'write_rows past tier end (row {row} of '
                         f'{self.rows})')
      mm[off:off + n] = block[done:done + n]
      if hasattr(mm, 'flush'):
        mm.flush()
      done += n
    # drop cached read-only views so later gathers see the write
    self._maps.clear()

  # ------------------------------------------------------------- access

  def _open(self, c: int, mode: str = 'r'):
    if mode == 'r' and c in self._maps:
      return self._maps[c]
    path = os.path.join(self.dir, _chunk_name(c, self.fmt))
    h = min(self.rows_per_chunk, self.rows - c * self.rows_per_chunk)
    if self.fmt == 'npy':
      mm = np.load(path, mmap_mode=mode)
    else:
      mm = np.memmap(path, dtype=self.dtype, mode=mode, shape=(h, self.dim))
    if mode == 'r':
      self._maps[c] = mm
    return mm

  def gather(self, rel_ids) -> np.ndarray:
    """Rows for tier-relative indices (any order, duplicates fine).
    Reads group by chunk so each touched chunk is one strided mmap
    take, not a per-row seek storm."""
    rel_ids = np.asarray(rel_ids, np.int64).reshape(-1)
    if rel_ids.size == 0:
      return np.zeros((0, self.dim), self.dtype)
    if rel_ids.min() < 0 or rel_ids.max() >= self.rows:
      raise IndexError(f'tier row out of range [0, {self.rows}): '
                       f'[{rel_ids.min()}, {rel_ids.max()}]')
    out = np.empty((rel_ids.shape[0], self.dim), self.dtype)
    chunks = rel_ids // self.rows_per_chunk
    order = np.argsort(chunks, kind='stable')
    sorted_chunks = chunks[order]
    bounds = np.flatnonzero(np.diff(sorted_chunks)) + 1
    for grp in np.split(order, bounds):
      c = int(chunks[grp[0]])
      mm = self._open(c)
      out[grp] = mm[rel_ids[grp] - c * self.rows_per_chunk]
    return out

  @property
  def shape(self):
    return (self.rows, self.dim)

  @property
  def nbytes(self) -> int:
    return self.rows * self.dim * self.dtype.itemsize

  def close(self):
    """Drop cached mmap views (handles close with the views)."""
    self._maps.clear()


def spill_array(dir_path: str, array, rows_per_chunk: int = 65536,
                fmt: str = 'npy') -> DiskTier:
  """Write ``array`` to a DiskTier at ``dir_path`` — the one-call spill
  used by TieredFeature / the serving materializer."""
  return DiskTier.write(dir_path, array, rows_per_chunk=rows_per_chunk,
                        fmt=fmt)
