"""Fused sample+gather CSR hop.

Counterpart of ``graphlearn_tpu/ops/sample_fused.py`` (``_draw``,
``sample_hop_fused``). The offset draw is plain torch on the port's
threefry stream, byte for byte the JAX package's; the adjacency gather
``indices[safe_epos]`` is the kernel's job. On a CUDA tensor it launches
``csrc/sample_hop.cu`` (one thread per pick); on a CPU tensor it runs the
plain ``indices[safe_epos]``.

The JAX kernel reads a ``[ceil(E/128), 128]`` lane-aligned view of the
indices (``build_indices128``), a TPU layout. The port reads the flat
``[E]`` indices, so ``blocks128`` must be None here, and it takes no
``window``: the JAX kernel's segment staging has no counterpart (see
``csrc/sample_hop.cu``).
"""
import torch

from .. import random as trandom
from . import kernels
from .unique import FILL

# launches of the CUDA kernel (plain-version calls do not count)
launches = 0


def _seed_rows(indptr, meta, seeds, seed_mask):
  """(start, deg) ``[B]`` int32 of each seed's CSR row; masked seeds read
  row 0. ``meta`` is the packed ``[N, 2]`` row table, or None for two
  ``indptr`` reads."""
  safe = torch.where(seed_mask, seeds, 0).long()
  if meta is not None:
    row = meta[safe]
    return row[:, 0].contiguous(), row[:, 1].contiguous()
  start = indptr[safe]
  return start, indptr[safe + 1] - start


def _draw(start, deg, seed_mask, k: int, key):
  """The uniform offset draw of ``ops.uniform_sample``. The offset is
  ``floor(u * float32(deg))`` in float32, clamped to ``deg - 1``; deg <=
  k keeps the first deg slots in order."""
  b = seed_mask.shape[0]
  u = trandom.uniform(key, (b, k), device=start.device)
  d = deg[:, None]
  rand_off = torch.floor(u * d.to(torch.float32)).to(torch.int32)
  rand_off = torch.minimum(rand_off, torch.clamp(d - 1, min=0))
  seq_off = torch.arange(k, dtype=torch.int32, device=start.device)[None, :]
  offsets = torch.where(d > k, rand_off, seq_off)
  mask = seed_mask[:, None] & (offsets < d)
  epos = start[:, None] + offsets
  return epos, mask


def sample_hop_plain(indices, safe_epos):
  """``indices[safe_epos]`` in plain torch (any device)."""
  return indices[safe_epos.long()]


def sample_hop(indices, safe_epos):
  """``indices[safe_epos]`` for one hop.

  Args:
    indices: ``[E]`` int32 CSR indices (E > 0).
    safe_epos: ``[B, k]`` int32 edge positions in ``[0, E)``.

  Returns ``[B, k]`` int32 (raw: masked slots read ``indices[epos]``).
  """
  if indices.device.type == 'cpu' and safe_epos.device.type == 'cpu':
    return sample_hop_plain(indices, safe_epos)
  _check(indices, safe_epos)
  global launches
  out = torch.empty(safe_epos.shape, dtype=torch.int32,
                    device=indices.device)
  if out.numel() == 0:
    return out
  err = kernels.lib('sample_hop').glt_sample_hop(
      indices.data_ptr(), indices.shape[0], safe_epos.data_ptr(),
      out.data_ptr(), out.numel(), indices.device.index or 0,
      torch.cuda.current_stream(indices.device).cuda_stream)
  kernels.check(err, 'sample_hop')
  launches += 1
  return out


def _check(indices, safe_epos):
  dev = indices.device
  if dev.type != 'cuda' or safe_epos.device != dev:
    raise ValueError('sample_hop: indices and epos must lie on one CUDA '
                     'device')
  for name, t, nd in (('indices', indices, 1), ('epos', safe_epos, 2)):
    if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
      raise ValueError(f'sample_hop: {name} must be a contiguous {nd}-D '
                       f'int32 tensor, got {tuple(t.shape)} {t.dtype}')
  if indices.shape[0] == 0:
    raise ValueError('sample_hop: empty indices')


def sample_hop_fused(indptr, indices, blocks128, seeds, seed_mask, k: int,
                     key, meta=None):
  """One uniform CSR hop; the output contract and PRNG stream of
  ``ops.uniform_sample``.

  Args:
    indptr / indices: the CSR (``indptr`` is read when ``meta`` is None).
    blocks128: must be None (the port reads the flat indices).
    seeds / seed_mask: ``[B]`` int32 / bool.
    k: fanout. key: threefry key (``random.PRNGKey`` family).
    meta: optional ``[N, 2]`` (start, degree) row table.

  Returns ``(nbrs [B, k] FILL-padded, epos [B, k] 0-padded, mask [B, k])``.
  """
  if blocks128 is not None:
    raise ValueError('the port reads the flat indices: pass blocks128=None')
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)
  if indices.shape[0] == 0:
    picked = torch.zeros_like(safe_epos)
  else:
    picked = sample_hop(indices, safe_epos)
  nbrs = torch.where(mask, picked, FILL)
  return nbrs, safe_epos, mask
