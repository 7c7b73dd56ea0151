"""Frontier-capacity calibration for exact-dedup sampling.

The port's own numpy copy of ``graphlearn_tpu/sampler/calibrate.py``
(``_sim_expand``, ``estimate_frontier_caps``, ``check_no_overflow``).
Static shapes size every exact-dedup buffer for the worst case
(``caps[i+1] = caps[i] * k``), while real deduped frontiers run several
times smaller; ``estimate_frontier_caps`` simulates the sampler's per-hop
dedup over a few probe batches and returns per-hop caps with slack. It
makes the same ``rng`` calls in the same order as the JAX function, so
it returns the same caps for the same graph, pool and seed. It reads the
host ``Topology``, never the device CSR. Sampling stays exact while no
batch overflows a cap; the sampler flags a batch that does
(``metadata['overflow']``).
"""
from typing import List, Optional, Sequence

import numpy as np


def _round_up(n: int, m: int) -> int:
  return max(m, ((n + m - 1) // m) * m)


def _sim_expand(indptr, indices, frontier, k, rng):
  """Numpy mirror of the uniform hop over ``frontier``: k draws with
  replacement for rows with degree > k, keep-all below (keep-all yields
  more distinct neighbors, so simulating it matters for an upper
  bound). Returns the (non-unique) candidate array."""
  deg = indptr[frontier + 1] - indptr[frontier]
  cand = []
  hi = frontier[deg > k]
  if hi.size:
    off = (rng.random((hi.size, k))
           * (indptr[hi + 1] - indptr[hi])[:, None]).astype(np.int64)
    cand.append(indices[indptr[hi][:, None] + off].ravel())
  lo = frontier[(deg > 0) & (deg <= k)]
  if lo.size:
    dlo = indptr[lo + 1] - indptr[lo]
    j = np.arange(k)[None, :]
    take = j < dlo[:, None]
    idx = indptr[lo][:, None] + np.minimum(j, np.maximum(
        dlo[:, None] - 1, 0))
    cand.append(indices[idx][take])
  if not cand:
    return np.empty((0,), np.int64)
  return np.concatenate(cand)


def estimate_frontier_caps(graph, fanouts: Sequence[int], batch_size: int,
                           input_nodes=None, num_probes: int = 8,
                           slack: float = 1.5, seed: int = 0,
                           multiple: int = 128) -> List[int]:
  """Estimate per-hop post-dedup frontier capacities.

  Args:
    graph: ``data.Graph`` (its host ``topo`` is read) or a ``Topology``.
    fanouts: the sampler's fanout list.
    batch_size: seed batch capacity.
    input_nodes: optional seed pool to draw probe seeds from (default:
      all nodes).
    num_probes: probe batches to simulate.
    slack: multiplier over the observed per-hop maximum.
    multiple: round each cap up to this multiple.

  Returns per-hop caps (``len(fanouts)`` of them) for
  ``NeighborSampler(frontier_caps=...)``.
  """
  src = getattr(graph, 'topo', graph)
  indptr = np.asarray(src.indptr)
  indices = np.asarray(src.indices)
  n = indptr.shape[0] - 1
  pool = (np.asarray(input_nodes).reshape(-1)
          if input_nodes is not None else None)
  rng = np.random.default_rng(seed)
  maxima = np.zeros(len(fanouts), np.int64)
  for _ in range(num_probes):
    seeds = (rng.choice(pool, batch_size)
             if pool is not None else rng.integers(0, n, batch_size))
    frontier = np.unique(seeds)
    seen = frontier
    for i, k in enumerate(fanouts):
      cand = _sim_expand(indptr, indices, frontier, k, rng)
      if cand.size == 0:
        break
      uniq = np.unique(cand)
      new = uniq[~np.isin(uniq, seen, assume_unique=True)]
      maxima[i] = max(maxima[i], new.size)
      seen = np.union1d(seen, new)
      frontier = new
      if frontier.size == 0:
        break
  return [_round_up(int(m * slack), multiple) for m in maxima]


def check_no_overflow(sampler, out, batch_cap: Optional[int] = None):
  """True iff no hop of ``out`` exceeded the sampler's frontier caps
  (reads the counts on the host: call at epoch end, not per batch)."""
  caps = sampler.hop_caps(batch_cap or out.batch.shape[0])
  counts = [int(c) for c in out.num_sampled_nodes]
  return all(c <= cap for c, cap in zip(counts[1:], caps[1:]))
