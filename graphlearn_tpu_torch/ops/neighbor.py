"""Fixed-shape uniform neighbor sampling over a device CSR.

Counterpart of ``graphlearn_tpu/ops/neighbor.py:uniform_sample`` in plain
torch: a dense ``[B, K]`` draw with a validity mask (deg <= K keeps all
neighbors in order; deg > K draws K with replacement). It is the plain
version of the fused hop (``ops.sample_fused``): same draw, and the
gather done by torch indexing.
"""
import torch

from .sample_fused import _draw, _seed_rows, sample_hop_plain
from .unique import FILL


def uniform_sample(indptr, indices, seeds, seed_mask, k: int, key,
                   meta=None):
  """Sample up to ``k`` neighbors per seed.

  Returns ``(nbrs [B, K] FILL-padded, epos [B, K] 0-padded, mask)``.
  """
  start, deg = _seed_rows(indptr, meta, seeds, seed_mask)
  epos, mask = _draw(start, deg, seed_mask, k, key)
  safe_epos = torch.where(mask, epos, 0)
  if indices.shape[0] == 0:
    picked = torch.zeros_like(safe_epos)
  else:
    picked = sample_hop_plain(indices, safe_epos)
  return torch.where(mask, picked, FILL), safe_epos, mask
