"""Frontier-capacity calibration for exact-dedup sampling.

The port's own numpy copy of ``graphlearn_tpu/sampler/calibrate.py``
(``_sim_expand``, ``estimate_frontier_caps``,
``estimate_hetero_frontier_caps``, ``normalize_hetero_frontier_caps``,
``clamp_etype_cap``, ``link_seed_width``, ``check_no_overflow``).
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


def estimate_hetero_frontier_caps(graph, num_neighbors, seed_caps,
                                  edge_dir: str = 'out', input_nodes=None,
                                  num_probes: int = 8, slack: float = 1.5,
                                  seed: int = 0,
                                  multiple: int = 128) -> dict:
  """Per-(hop, edge-type) post-dedup calibration for the typed engine.

  The hetero worst-case plan compounds per hop ACROSS edge types
  (``hetero_capacity_plan``: each hop's frontier is the sum of every
  contributing etype's full ``fcap * k``), so a reference-shaped config
  (batch 5120 x 3 typed hops, the IGBH RGNN example's defaults)
  statically exceeds the graph itself. Real typed frontiers saturate at
  the type's population long before that — this probe measures them.

  The simulation mirrors the typed engine's ``_hetero_sample_from_nodes``
  and makes the JAX function's ``rng`` calls in its order, so it returns
  the same caps:
  canonical (sorted) intra-hop edge-type order, sequential per-type
  dedup within a hop (a later etype's candidates dedup against an
  earlier etype's additions), per-type ``seen`` sets across hops.

  Args:
    graph: ``{edge_type: data.Graph}`` (the sampler's hetero dict); the
      host ``topo`` of each is read.
    num_neighbors: per-etype fanout dict or shared list.
    seed_caps: ``{ntype: batch_cap}`` — the loader's seed widths.
    edge_dir: 'out' (CSR by src) or 'in' (CSC by dst), as the dataset.
    input_nodes: optional ``{ntype: seed pool}`` to draw probe seeds
      from (defaults to each type's full id range).
    num_probes / slack / seed / multiple: as estimate_frontier_caps.

  Returns ``{edge_type: [per-hop caps]}`` for
  ``NeighborSampler(frontier_caps=...)`` on a hetero graph — hop h's
  entry clamps the NEW unique nodes etype ``et`` may add to its result
  type at hop h (the engine's ``max_new``).
  """
  etypes = sorted(tuple(et) for et in graph)
  fanouts_of = ((lambda et: list(num_neighbors[et]))
                if isinstance(num_neighbors, dict)
                else (lambda et: list(num_neighbors)))
  num_hops = max(len(fanouts_of(et)) for et in etypes)
  csr = {}
  for et, g in graph.items():
    src = getattr(g, 'topo', g)
    csr[tuple(et)] = (np.asarray(src.indptr), np.asarray(src.indices))
  rng = np.random.default_rng(seed)
  maxima = {et: np.zeros(num_hops, np.int64) for et in etypes}
  for _ in range(num_probes):
    frontier = {}
    seen = {}
    for t, cap in seed_caps.items():
      pool = None if input_nodes is None else input_nodes.get(t)
      n_t = None
      if pool is not None:
        pool = np.asarray(pool).reshape(-1)
        seeds = rng.choice(pool, cap)
      else:
        # seed id range: the src dimension of any etype keyed by t
        for et in etypes:
          key_t = et[0] if edge_dir == 'out' else et[2]
          if key_t == t:
            n_t = csr[et][0].shape[0] - 1
            break
        if n_t is None:
          continue
        seeds = rng.integers(0, n_t, cap)
      frontier[t] = np.unique(seeds)
      seen[t] = frontier[t]
    for hop in range(num_hops):
      parts = {}
      for et in etypes:
        fo = fanouts_of(et)
        if hop >= len(fo) or fo[hop] == 0:
          continue
        key_t = et[0] if edge_dir == 'out' else et[2]
        res_t = et[2] if edge_dir == 'out' else et[0]
        f = frontier.get(key_t)
        if f is None or f.size == 0:
          continue
        indptr, indices = csr[et]
        cand = _sim_expand(indptr, indices, f, fo[hop], rng)
        if cand.size == 0:
          continue
        uniq = np.unique(cand)
        prev = seen.get(res_t)
        new = (uniq if prev is None
               else uniq[~np.isin(uniq, prev, assume_unique=True)])
        maxima[et][hop] = max(maxima[et][hop], new.size)
        seen[res_t] = new if prev is None else np.union1d(prev, new)
        parts.setdefault(res_t, []).append(new)
      frontier = {t: np.concatenate(v) for t, v in parts.items()}
  return {et: [_round_up(int(m * slack), multiple) for m in maxima[et]]
          for et in etypes}


def normalize_hetero_frontier_caps(frontier_caps, known_etypes) -> dict:
  """Validate + normalize dict-form hetero caps to
  ``{tuple(etype): tuple(int|None per hop)}`` — the ONE contract shared
  by the samplers (None = no clamp at that hop).
  Raises the shared error messages on list-form caps or unknown edge
  types."""
  if not isinstance(frontier_caps, dict):
    raise ValueError(
        'list-form frontier_caps is homogeneous-only; hetero graphs '
        'take a {edge_type: [per-hop caps]} dict '
        '(calibrate.estimate_hetero_frontier_caps)')
  known = {tuple(et) for et in known_etypes}
  fc = {}
  for et, caps in frontier_caps.items():
    et = tuple(et)
    if et not in known:
      raise ValueError(f'frontier_caps edge type {et!r} is not in '
                       'the graph')
    fc[et] = tuple(None if c is None else int(c) for c in caps)
  return fc


def clamp_etype_cap(etype_caps, et, hop: int, worst: int) -> int:
  """The per-(hop, edge-type) clamp rule of ``hetero_capacity_plan``: one
  implementation, so the engine's buffer plan and the layout helpers'
  offsets cannot drift apart."""
  if etype_caps is None:
    return worst
  ec = etype_caps.get(et)
  if ec is not None and hop < len(ec) and ec[hop] is not None:
    return min(worst, int(ec[hop]))
  return worst


def link_seed_width(batch_size: int, neg_sampling=None) -> int:
  """The seed width of one link batch: src and dst of each positive, and
  the negatives' endpoints sampled beside them (binary: both, triplet:
  the dst candidate). The width to calibrate a link loader's caps at."""
  if neg_sampling is None:
    return 2 * batch_size
  num_neg = neg_sampling.num_negatives(batch_size)
  return 2 * batch_size + \
      (2 * num_neg if neg_sampling.is_binary() else num_neg)


def check_no_overflow(sampler, out, batch_cap: Optional[int] = None):
  """True iff no hop of ``out`` exceeded the sampler's frontier caps
  (reads the counts on the host: call at epoch end, not per batch)."""
  caps = sampler.hop_caps(batch_cap or out.batch.shape[0])
  counts = [int(c) for c in out.num_sampled_nodes]
  return all(c <= cap for c, cap in zip(counts[1:], caps[1:]))
