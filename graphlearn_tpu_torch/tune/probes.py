"""Workload probes behind `tune()`: each returns (value, evidence).

Counterpart of ``graphlearn_tpu/tune/probes.py``, with the same values
and the same evidence dicts. Every probe is host numpy over the CSR
topology (the ``sampler/calibrate.py`` discipline: nothing runs on the
card and nothing is read back from it) and returns both the chosen value
and a record naming what was measured, so the artifact can answer "why
this cap / split / K" from the record alone. The card-measured half of
tuning, the candidate A/Bs, lives in ``tuner.py``.

Probe inventory:

* frontier caps     -> sampler.calibrate.estimate_frontier_caps
* cache split       -> in-degree hotness mass coverage (data/reorder's
                       hotness estimator: what fraction of expected
                       accesses the hottest rows absorb)
* scan chunk K      -> divisor-preferring ladder over the epoch's step
                       count (fewest chunk lengths first, dispatch count
                       second)
* staging slab cap  -> pow2 of the planned per-chunk miss volume
                       (storage/staging.py's closed-shape convention)
* serving buckets   -> pow2 ladder under the calibrated batch cap
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..sampler import calibrate
from ..storage.staging import pow2_slab_cap

#: candidate chunk sizes, largest preferred (fewer dispatches) — the
#: ladder the divisor rule walks (docs/tuning.md)
CHUNK_K_LADDER = (64, 32, 16, 8, 4)

#: default serving-bucket ladder seed (serving/engine.py
#: DEFAULT_BUCKETS) — the probe extends it to cover the batch cap
SERVING_BUCKET_BASE = (16, 64, 256)


def probe_frontier_caps(graph, fanouts: Sequence[int], batch_size: int,
                        input_nodes=None, num_probes: int = 8,
                        slack: float = 1.5, seed: int = 0
                        ) -> Tuple[List[int], dict]:
  """Calibrated per-hop post-dedup caps (the existing probe, evidence-
  wrapped): worst-case static plan vs measured caps, so the artifact
  records how much buffer the calibration actually bought."""
  caps = calibrate.estimate_frontier_caps(
      graph, fanouts, batch_size, input_nodes=input_nodes,
      num_probes=num_probes, slack=slack, seed=seed)
  worst = [batch_size]
  for k in fanouts:
    worst.append(worst[-1] * k)
  worst = worst[1:]
  evidence = dict(
      knob='frontier_caps', probe='estimate_frontier_caps',
      value=list(caps), worst_case_plan=worst,
      num_probes=num_probes, slack=slack,
      plan_reduction_x=round(float(sum(worst)) / max(1, sum(caps)), 2))
  return list(caps), evidence


def probe_cache_split(graph, num_nodes: int, coverage: float = 0.75,
                      max_split: float = 0.5
                      ) -> Tuple[float, float, dict]:
  """(split_ratio, bucket_frac, evidence): the smallest hot fraction
  whose in-degree hotness mass reaches ``coverage`` of expected
  accesses (DCI's workload-aware allocation, arxiv 2503.01281, on the
  one signal a static graph gives us: in-degree ~ access frequency
  under uniform seed draws). bucket_frac then sizes the miss-exchange
  packing at the UNCOVERED mass plus slack — a hot split that absorbs
  more hits needs a narrower wire."""
  from ..data.reorder import in_degree_hotness
  hot = np.asarray(in_degree_hotness(
      getattr(graph, 'topo', graph), num_nodes), np.float64)
  total = float(hot.sum())
  if total <= 0:
    evidence = dict(knob='split_ratio', probe='in_degree_hotness',
                    value=0.0, note='degenerate graph (no edges)')
    return 0.0, 1.0, evidence
  mass = np.cumsum(np.sort(hot)[::-1]) / total
  # smallest prefix fraction reaching the coverage target, clamped to
  # max_split (a cache past half the table stops being a cache); the
  # covered mass is read AT THE CLAMPED prefix — bucket_frac must size
  # the miss wire for what the chosen split actually absorbs, not for
  # the coverage an unclamped split would have reached
  idx = int(np.searchsorted(mass, coverage)) + 1
  idx = max(1, min(idx, num_nodes, int(max_split * num_nodes) or 1))
  split = idx / num_nodes
  covered = float(mass[idx - 1])
  bucket_frac = round(min(1.0, max(0.25, (1.0 - covered) * 1.5)), 2)
  evidence = dict(
      knob='split_ratio', probe='in_degree_hotness',
      value=round(float(split), 4), coverage_target=coverage,
      coverage_at_split=round(covered, 4),
      bucket_frac=bucket_frac,
      note='bucket_frac = clamp(1.5 x uncovered access mass)')
  return round(float(split), 4), bucket_frac, evidence


def probe_chunk_k(steps: int, ladder: Sequence[int] = CHUNK_K_LADDER
                  ) -> Tuple[int, dict]:
  """Scan chunk K: prefer the largest ladder K that DIVIDES the epoch
  (one chunk-length executable, fewest dispatches); otherwise the
  largest K whose tail chunk is the only extra executable. K is the
  dispatch-count lever — ceil(steps/K)+2 — but every distinct chunk
  length compiles once, so divisibility outranks raw size."""
  steps = max(1, int(steps))
  fits = [k for k in ladder if k <= steps]
  if not fits:
    choice, why = steps, 'epoch shorter than the ladder: one chunk'
  else:
    divisors = [k for k in fits if steps % k == 0]
    if divisors:
      choice = divisors[0]
      why = f'largest ladder divisor of {steps} steps (one executable)'
    else:
      choice = fits[0]
      why = (f'no ladder divisor of {steps} steps; largest K with one '
             'tail executable')
  evidence = dict(
      knob='chunk_k', probe='divisor_ladder', value=int(choice),
      steps=steps, ladder=list(ladder),
      dispatches=-(-steps // choice) + 2, why=why)
  return int(choice), evidence


def probe_slab_cap(chunk_k: int, frontier_caps: Sequence[int],
                   batch_size: int, split_ratio: float
                   ) -> Tuple[int, dict]:
  """Staging slab capacity: pow2 of the planned per-chunk miss volume
  — chunk_k steps x the calibrated unique-node budget x the slice the
  hot split does NOT absorb (storage/staging.py pads slabs to pow2
  with INT32_MAX ids, so this is the closed-shape knob)."""
  node_budget = int(batch_size + sum(frontier_caps))
  miss = max(1, int(chunk_k * node_budget * (1.0 - split_ratio)))
  cap = pow2_slab_cap(miss)
  evidence = dict(
      knob='slab_cap', probe='planned_miss_volume', value=int(cap),
      per_step_node_budget=node_budget, chunk_k=int(chunk_k),
      split_ratio=split_ratio, planned_miss_rows=miss)
  return int(cap), evidence


def probe_serving_buckets(batch_size: int,
                          base: Sequence[int] = SERVING_BUCKET_BASE
                          ) -> Tuple[List[int], dict]:
  """Serving bucket ladder: the engine's default pow2-ish ladder
  extended until one bucket covers the training batch cap (an online
  request fan-in rarely exceeds the trained batch; oversize requests
  split at the largest cap — serving/engine.py)."""
  buckets = sorted(set(int(b) for b in base))
  top = buckets[-1]
  while top < batch_size:
    top *= 4
    buckets.append(top)
  evidence = dict(knob='serving_buckets', probe='batch_cap_ladder',
                  value=list(buckets), batch_size=int(batch_size))
  return buckets, evidence


def epoch_steps(num_seeds: int, batch_size: int,
                drop_last: bool = False) -> int:
  """The SeedBatcher step arithmetic, duplicated nowhere else."""
  if drop_last:
    return num_seeds // batch_size
  return -(-num_seeds // batch_size)


def wire_dtype_choice(exact: bool) -> Tuple[Optional[str], dict]:
  """bf16 wire is certified semantics-free for FEATURE payloads by the
  accuracy matrix (benchmarks/accuracy_matrix.py: precision delta
  only, bounded by bf16 rounding of inputs) — chosen unless the caller
  pinned the exact set."""
  value = None if exact else 'bf16'
  evidence = dict(
      knob='wire_dtype', probe='accuracy_matrix',
      value=value,
      note=('exact=True pins full-width f32 wire' if exact else
            'bf16 feature wire: accuracy-matrix-certified relaxation '
            '(benchmarks/accuracy_matrix.py)'))
  return value, evidence
