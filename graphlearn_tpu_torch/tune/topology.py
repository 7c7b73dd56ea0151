"""Per-topology candidate fields for `tune()`.

Counterpart of ``graphlearn_tpu/tune/topology.py``. The distributed
topologies' marquee knobs are store-construction parameters (the dist
exchange's ``bucket_frac`` / ``split_ratio`` / wire dtype, the remote
block streams' ``block_ahead`` / ``block_wire_dtype``, the tiered
exchange's slab caps and ``hot_prefix_rows``), so each candidate is a
freshly BUILT scenario: the caller supplies
``loader_cfg['make_scenario'](knobs, chunk_k) -> (trainer, state)`` and
every candidate runs through the local path's scoring rule:

1. **Feasibility screen first** (host arithmetic, nothing on the card):
   the dist exchange's analytic all-to-all volume
   (``distributed.dist_feature.feature_exchange_mb``), the remote block
   frames' in-flight MB (``distributed.block_producer.block_mb_per_chunk``
   x ``block_ahead``) and the tiered slab plan's pow2 cap
   (``storage.staging.pow2_slab_cap``, or ``loader_cfg['plan_fn']`` over
   ``storage.planner.plan_exchange``) against the caller's quotas: an
   infeasible candidate is rejected with the analytic numbers before it
   runs an epoch.
2. **Compile phase, then steady epoch** over the scenario's program
   sites (``TOPOLOGY_SITES``, the names the port's distributed and
   remote trainers record): any steady-state capture disqualifies, with
   the signature diff. As in ``tuner.py``, the compile phase runs the
   probe epoch once more when a capturing trainer left a chunk length
   uncaptured (its first chunk is an eager warm-up), and the steady
   wall is read after ``torch.cuda.synchronize``. Qualified candidates
   rank by steady wall per step; the tie-break is the wall.

The result is one fingerprint-validated
:class:`~graphlearn_tpu_torch.tune.artifact.TuneArtifact` per topology
that the MATCHING trainer's ``config=`` accepts (and a mismatched one
refuses).
"""
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import metrics
from ..metrics import programs, spans
from . import probes
from .artifact import TuneArtifact, dataset_fingerprint
from .tuner import _chunk_lengths, _pick_winner, _share_stream, _sync

#: the trainer scenarios tune() fields candidates for, and the program
#: sites each one dispatches through — the population the "zero
#: steady-state compiles" acceptance counts per topology
TOPOLOGY_SITES = {
    'local': ('epoch_seeds', 'scan_chunk', 'metrics_concat'),
    'dist': ('dist_epoch_seeds', 'dist_scan_chunk',
             'dist_metrics_concat'),
    'tiered_dist': ('dist_epoch_seeds', 'dist_scan_chunk',
                    'dist_metrics_concat'),
    'remote': ('remote_epoch_begin', 'remote_scan_chunk',
               'remote_metrics_concat'),
}

#: which artifact choice keys each topology's candidate knobs may set
#: — a candidate naming a knob outside its topology's field is a
#: construction error, not evidence
TOPOLOGY_KNOBS = {
    'dist': frozenset({'bucket_frac', 'split_ratio', 'wire_dtype'}),
    'remote': frozenset({'block_ahead', 'block_wire_dtype'}),
    'tiered_dist': frozenset({'bucket_frac', 'split_ratio',
                              'wire_dtype', 'slab_cap',
                              'hot_prefix_rows'}),
}


class TopologyCandidate:
  """One scenario candidate for a topology A/B.

  Args:
    name: evidence-log label.
    knobs: the scenario-construction knobs (TOPOLOGY_KNOBS subset for
      the topology) handed to ``make_scenario``.
    chunk_k: per-candidate chunk override (None = the probed K).
    exact_semantics: False for certified relaxations (bf16 wire).
  """

  def __init__(self, name: str, knobs: Dict, chunk_k: Optional[int] = None,
               exact_semantics: bool = True):
    self.name = name
    self.knobs = dict(knobs)
    self.chunk_k = chunk_k
    self.exact_semantics = exact_semantics


def default_topology_candidates(topology: str, cfg: Dict,
                                exact: bool) -> List[TopologyCandidate]:
  """The stock candidate field per topology: the full-width exact
  baseline first (the stable-sort tie-break anchor), the cache/prefetch
  variants, then the accuracy-matrix-certified bf16 wire unless
  ``exact=True`` pinned the exact set. Tiered fields need the
  caller's hot-prefix ladder (``cfg['hot_prefix_choices']``) — there
  is no topology-free default for a knob bounded by the shard's own
  row count."""
  if topology == 'dist':
    cands = [
        TopologyCandidate('dist_fullwidth',
                          dict(bucket_frac=None, split_ratio=0.0,
                               wire_dtype=None)),
        TopologyCandidate('dist_bucketed',
                          dict(bucket_frac=2.0, split_ratio=0.25,
                               wire_dtype=None)),
    ]
    if not exact:
      cands.append(TopologyCandidate(
          'dist_bucketed_bf16',
          dict(bucket_frac=2.0, split_ratio=0.25, wire_dtype='bf16'),
          exact_semantics=False))
    return cands
  if topology == 'remote':
    cands = [
        TopologyCandidate('remote_ahead2', dict(block_ahead=2,
                                                block_wire_dtype=None)),
        TopologyCandidate('remote_ahead1', dict(block_ahead=1,
                                                block_wire_dtype=None)),
    ]
    if not exact:
      cands.append(TopologyCandidate(
          'remote_ahead2_bf16',
          dict(block_ahead=2, block_wire_dtype='bf16'),
          exact_semantics=False))
    return cands
  if topology == 'tiered_dist':
    hots = cfg.get('hot_prefix_choices')
    if not hots:
      raise ValueError(
          "tune(topology='tiered_dist') needs either explicit "
          "candidates= or loader_cfg['hot_prefix_choices'] (the "
          'hot-prefix row ladder to field) — the knob is bounded by '
          'the shard row count, which only the caller knows '
          '(docs/tuning.md)')
    return [TopologyCandidate(f'tiered_hot{h}',
                              dict(hot_prefix_rows=int(h)))
            for h in hots]
  raise ValueError(f'no default candidate field for topology '
                   f'{topology!r}')


# ------------------------------------------------------------ analytics


def _choice_fanouts(fanouts):
  """Artifact-choice form of a fanout spec: typed dicts serialize with
  canonical string etype keys (typing.as_str) so the JSON round-trip
  is loss-free; flat lists stay flat."""
  if isinstance(fanouts, dict):
    from ..typing import as_str
    return {(as_str(et) if isinstance(et, (list, tuple)) else str(et)):
            [int(k) for k in f]
            for et, f in sorted(fanouts.items(), key=lambda kv:
                                str(kv[0]))}
  return [int(k) for k in fanouts]


def _flatten_fanouts(fanouts) -> List[int]:
  """Per-hop effective fan-out of a fanout spec. A typed dict sums the
  per-etype counts hop-wise — a frontier node can fan out along every
  relation at once, so the analytic budget is the hop-wise SUM, the
  same worst case the hetero CapacityPlan closes its shapes over
  (docs/capacity_plans.md)."""
  if isinstance(fanouts, dict):
    hops = max(len(f) for f in fanouts.values())
    return [sum(int(f[h]) for f in fanouts.values() if h < len(f))
            for h in range(hops)]
  return [int(k) for k in fanouts]


def _node_budget(fanouts, batch_size: int) -> int:
  """Worst-case per-step frontier node budget (seeds + every hop's
  full fan-out) — the static plan the feasibility analytics size
  against when the caller supplies no calibrated caps. Accepts a flat
  per-hop list or a typed per-etype dict."""
  total, width = batch_size, batch_size
  for k in _flatten_fanouts(fanouts):
    width *= int(k)
    total += width
  return int(total)


def screen_candidate(topology: str, cand: TopologyCandidate,
                     chunk_k: int, cfg: Dict) -> Tuple[bool, dict]:
  """Analytic feasibility of one candidate against the caller's
  quotas, BEFORE any device work. Returns (feasible, evidence). The
  quotas are opt-in (``max_exchange_mb`` / ``max_block_mb`` /
  ``max_slab_rows``); with none set every candidate screens feasible
  and the evidence still records the analytic volumes."""
  ev = dict(kind='feasibility', name=cand.name, topology=topology,
            feasible=True)
  unknown = set(cand.knobs) - TOPOLOGY_KNOBS[topology]
  if unknown:
    raise ValueError(
        f'candidate {cand.name!r} names knobs {sorted(unknown)} '
        f'outside the {topology!r} field {sorted(TOPOLOGY_KNOBS[topology])} '
        '(docs/tuning.md "Topology candidates")')
  fanouts = cfg['fanouts'] if isinstance(cfg['fanouts'], dict) \
      else [int(k) for k in cfg['fanouts']]
  batch = int(cfg['batch_size'])
  feat_dim = cfg.get('feat_dim')
  width = int(cfg.get('request_width') or _node_budget(fanouts, batch))
  if topology in ('dist', 'tiered_dist') and feat_dim:
    from ..distributed.dist_feature import feature_exchange_mb
    wire = cand.knobs.get('wire_dtype')
    mb = feature_exchange_mb(
        width, int(cfg.get('num_partitions', 1)), int(feat_dim),
        bucket_frac=cand.knobs.get('bucket_frac', 2.0),
        wire_bytes=2 if wire == 'bf16' else 4,
        hit_rate=float(cand.knobs.get('split_ratio') or 0.0))
    ev['exchange_mb'] = round(mb, 4)
    quota = cfg.get('max_exchange_mb')
    if quota is not None and mb > float(quota):
      ev.update(feasible=False, quota_mb=float(quota),
                rejected=f'analytic exchange volume {mb:.3f} MB/shard '
                         f'exceeds max_exchange_mb={quota} — rejected '
                         'before the A/B epoch')
  if topology == 'tiered_dist':
    from ..storage.staging import pow2_slab_cap
    plan_fn = cfg.get('plan_fn')
    if plan_fn is not None:
      # caller-supplied planner hook (typically a closure over
      # storage.planner.plan_exchange on the real seed matrix): the
      # EXACT per-chunk miss volume this candidate would stage
      miss = int(plan_fn(dict(cand.knobs), int(chunk_k)))
    else:
      hot = int(cand.knobs.get('hot_prefix_rows') or 0)
      rows = int(cfg.get('rows_per_shard') or 0)
      hot_frac = min(1.0, hot / rows) if rows else 0.0
      miss = int(chunk_k * width * (1.0 - hot_frac))
    cap = pow2_slab_cap(max(1, miss))
    ev['planned_miss_rows'] = int(miss)
    ev['slab_cap'] = int(cap)
    quota = cfg.get('max_slab_rows')
    if quota is not None and cap > int(quota):
      ev.update(feasible=False, quota_rows=int(quota),
                rejected=f'planned slab cap {cap} rows overflows '
                         f'max_slab_rows={quota} — rejected before '
                         'the A/B epoch')
  if topology == 'remote' and feat_dim:
    from ..distributed.block_producer import block_mb_per_chunk
    node_cap = int(cfg.get('node_cap') or _node_budget(fanouts, batch))
    edge_cap = int(cfg.get('edge_cap') or
                   (_node_budget(fanouts, batch) - batch))
    ahead = int(cand.knobs.get('block_ahead') or 2)
    mb = block_mb_per_chunk(int(chunk_k), node_cap, edge_cap,
                            int(feat_dim),
                            cand.knobs.get('block_wire_dtype'))
    ev['block_mb_per_chunk'] = round(mb, 4)
    ev['inflight_mb'] = round(mb * ahead, 4)
    quota = cfg.get('max_block_mb')
    if quota is not None and mb * ahead > float(quota):
      ev.update(feasible=False, quota_mb=float(quota),
                rejected=f'{ahead} in-flight block(s) x {mb:.3f} MB '
                         f'exceed max_block_mb={quota} — rejected '
                         'before the A/B epoch')
  if not ev['feasible']:
    metrics.inc('tune.rejected')
  return bool(ev['feasible']), ev


# -------------------------------------------------------------- scoring


def score_scenario_candidate(cand: TopologyCandidate, topology: str,
                             make_scenario: Callable, chunk_k: int,
                             probe_steps: Optional[int]) -> dict:
  """Build one candidate's scenario and run its compile + steady
  epochs under the topology's program sites — the same record shape
  (and the same disqualify-on-steady-compile rule) as the local
  path's ``score_candidate``."""
  sites = TOPOLOGY_SITES[topology]
  k = int(cand.chunk_k or chunk_k)
  steps = int(probe_steps or 2 * k)
  steps = max(k, (steps // k) * k)
  rec = dict(kind='candidate', name=cand.name, topology=topology,
             knobs=dict(cand.knobs), chunk_k=k,
             exact_semantics=cand.exact_semantics,
             probe_steps=steps)
  metrics.inc('tune.candidates')
  t_start = time.perf_counter()
  trainer = None
  try:
    with spans.span('tune.candidate', candidate=cand.name,
                    topology=topology, chunk_k=k):
      trainer, state = make_scenario(dict(cand.knobs), k)
      _share_stream(trainer)
      base = {s: programs.compile_count(s) for s in sites}
      # compile phase: every chunk length the steady epoch replays is
      # captured here (tuner.py's rule: a second probe epoch when the
      # first left one uncaptured behind its eager warm-up chunk)
      epoch_steps = getattr(trainer, '_epoch_steps', None)
      need = _chunk_lengths(
          min(steps, epoch_steps()) if epoch_steps else steps, k)
      compile_epochs = 0
      while True:
        state, losses, _ = trainer.run_epoch(state, max_steps=steps)
        compile_epochs += 1
        graphs = getattr(trainer, '_graphs', None)
        if not getattr(trainer, 'capture', False) or graphs is None or \
            need <= set(graphs) or compile_epochs == 2:
          break
      _sync(losses.device)
      after_compile = {s: programs.compile_count(s) for s in sites}
      # steady epoch: the measured one — ANY capture here disqualifies
      t0 = time.perf_counter()
      state, losses, _ = trainer.run_epoch(state, max_steps=steps)
      _sync(losses.device)
      wall = time.perf_counter() - t0
      rec['compile_epochs'] = compile_epochs
      after_steady = {s: programs.compile_count(s) for s in sites}
      rec['compile_epoch_compiles'] = {
          s: after_compile[s] - base[s] for s in sites}
      steady = {s: after_steady[s] - after_compile[s] for s in sites}
      rec['steady_epoch_compiles'] = steady
      rec['wall_s'] = round(wall, 6)
      retraced = sum(steady.values()) > 0
      rec['qualified'] = not retraced
      if retraced:
        site = max(steady, key=steady.get)
        ev = programs.last_compile(site)
        rec['rejected'] = (
            f'steady-state epoch compiled {sum(steady.values())} '
            f'program(s) — a tuned config must dispatch a CLOSED '
            'executable set')
        rec['retrace_diff'] = ev.diff if ev is not None else None
        metrics.inc('tune.rejected')
  except Exception as e:  # a broken candidate is evidence, not a crash
    rec['qualified'] = False
    rec['rejected'] = f'{type(e).__name__}: {e}'[:300]
    metrics.inc('tune.rejected')
  finally:
    for fin in ('shutdown', 'close'):
      fn = getattr(trainer, fin, None)
      if fn is not None:
        try:
          fn()
        except Exception:  # noqa: BLE001 - teardown must not mask the score
          pass
        break
    # release the scenario (its captured graphs and stores) before the
    # next candidate's is built
    trainer = state = losses = None
    gc.collect()
    if torch.cuda.is_available():
      torch.cuda.empty_cache()
  metrics.observe('tune.probe_ms',
                  (time.perf_counter() - t_start) * 1e3)
  return rec


def _budget_ladder(records: List[dict], pending: List, budget_s: float,
                   first_wall: float) -> Tuple[List, dict]:
  """Tune-the-tuner: truncate the remaining candidate ladder to what
  an explicit wall-clock budget affords, using the FIRST scored
  candidate's measured wall as the per-candidate unit. The evidence
  record makes the truncation loud — a budget-bounded tune says which
  candidates it never fielded (docs/tuning.md 'Budgeted tuning')."""
  per = max(first_wall, 1e-6)
  afford = max(0, int(budget_s / per) - len(records))
  kept, dropped = pending[:afford], pending[afford:]
  ev = dict(kind='budget', budget_s=float(budget_s),
            per_candidate_wall_s=round(per, 6),
            scored=len(records), kept=[c.name for c in kept],
            dropped=[c.name for c in dropped])
  return kept, ev


def tune_topology(topology: str, dataset, loader_cfg: Dict, *,
                  exact: bool = False,
                  candidates: Optional[Sequence[TopologyCandidate]] = None,
                  probe_steps: Optional[int] = None,
                  budget_s: Optional[float] = None,
                  out_path: Optional[str] = None) -> TuneArtifact:
  """tune() for a distributed topology (module docstring;
  dispatched from :func:`graphlearn_tpu_torch.tune.tune` via
  ``topology='dist'|'remote'|'tiered_dist'``).

  ``loader_cfg`` must carry ``make_scenario(knobs, chunk_k) ->
  (trainer, state)`` plus ``fanouts`` and ``batch_size``; optional
  keys feed the feasibility analytics (``feat_dim``,
  ``num_partitions``, ``rows_per_shard`` / ``plan_fn``, ``node_cap``/
  ``edge_cap``) and quotas (``max_exchange_mb``, ``max_block_mb``,
  ``max_slab_rows``). ``epoch_steps`` (or ``input_nodes``) sizes the
  chunk-K probe."""
  if topology not in TOPOLOGY_SITES or topology == 'local':
    raise ValueError(
        f'unknown tune topology {topology!r} — the scenario set is '
        f"closed ({sorted(TOPOLOGY_SITES)}; 'local' takes the "
        'homo-scan path, docs/tuning.md)')
  cfg = dict(loader_cfg)
  make_scenario = cfg.get('make_scenario')
  if not callable(make_scenario):
    raise ValueError(
        f"tune(topology={topology!r}) needs loader_cfg"
        "['make_scenario'](knobs, chunk_k) -> (trainer, state): the "
        'scenario knobs are store-construction parameters, so every '
        'candidate is a freshly built scenario (docs/tuning.md '
        '"Topology candidates")')
  if 'fanouts' not in cfg or 'batch_size' not in cfg:
    raise ValueError("loader_cfg needs 'fanouts' and 'batch_size' — "
                     'they pin the artifact choices and size the '
                     'feasibility analytics')
  evidence: List[dict] = []
  with spans.span('tune.run', topology=topology, exact=exact):
    if 'epoch_steps' in cfg:
      steps = int(cfg['epoch_steps'])
    elif 'input_nodes' in cfg:
      inp = cfg['input_nodes']
      if isinstance(inp, tuple) and len(inp) == 2 and \
          isinstance(inp[0], str):
        inp = inp[1]  # typed seeds: ('ntype', ids)
      steps = probes.epoch_steps(
          np.asarray(inp).reshape(-1).shape[0],
          int(cfg['batch_size']), bool(cfg.get('drop_last', False)))
    else:
      steps = 2 * probes.CHUNK_K_LADDER[-1]
    chunk_k, ev = probes.probe_chunk_k(steps)
    evidence.append(ev)
    fp = dataset_fingerprint(dataset)
    if fp is None:
      # structured fingerprint-gap record (satellite of ROADMAP item
      # 3): the artifact says OUT LOUD that no dataset identity could
      # be computed, so an unvalidated acceptance downstream is a
      # recorded fact, not a silent one
      evidence.append(dict(
          kind='fingerprint_gap', topology=topology,
          dataset_type=type(dataset).__name__,
          note='dataset has no computable fingerprint — config= '
               'acceptors will warn instead of validating '
               '(docs/tuning.md "Fingerprints")'))
    cands = list(candidates) if candidates is not None \
        else default_topology_candidates(topology, cfg, exact)
    if exact:
      dropped = [c.name for c in cands if not c.exact_semantics]
      cands = [c for c in cands if c.exact_semantics]
      if dropped:
        evidence.append(dict(
            kind='exact_pin', dropped_candidates=dropped,
            note='exact=True pins the accuracy-matrix exact set'))
    feasible: List[TopologyCandidate] = []
    for cand in cands:
      ok, ev = screen_candidate(topology, cand,
                                int(cand.chunk_k or chunk_k), cfg)
      evidence.append(ev)
      if ok:
        feasible.append(cand)
      else:
        evidence.append(dict(kind='candidate', name=cand.name,
                             topology=topology, knobs=dict(cand.knobs),
                             qualified=False,
                             rejected=ev.get('rejected')))
    if not feasible:
      raise RuntimeError(
          f'tune(topology={topology!r}): every candidate screened '
          'infeasible against the configured quotas — see the '
          'feasibility evidence records')
    records: List[dict] = []
    pending = list(feasible)
    while pending:
      cand = pending.pop(0)
      records.append(score_scenario_candidate(
          cand, topology, make_scenario, chunk_k, probe_steps))
      if budget_s is not None and len(records) == 1 and pending:
        pending, ev = _budget_ladder(records, pending, budget_s,
                                     records[0].get('wall_s') or 0.0)
        evidence.append(ev)
    evidence.extend(records)
    best = _pick_winner(records)
    knobs = best.get('knobs') or {}
    evidence.append(dict(kind='winner', name=best['name'],
                         topology=topology, wall_s=best['wall_s'],
                         tie_break=best.get('tie_break', 'wall'),
                         knobs=dict(knobs)))
    choices = dict(
        mode='map',
        frontier_caps=cfg.get('frontier_caps'),
        padded_window=None,
        wire_dtype=knobs.get('wire_dtype'),
        chunk_k=int(best['chunk_k']),
        split_ratio=knobs.get('split_ratio'),
        bucket_frac=knobs.get('bucket_frac'),
        slab_cap=knobs.get('slab_cap'),
        serving_buckets=None,
        batch_size=int(cfg['batch_size']),
        fanouts=_choice_fanouts(cfg['fanouts']),
        exact=bool(exact),
        topology=topology,
        hot_prefix_rows=knobs.get('hot_prefix_rows'),
        block_ahead=knobs.get('block_ahead'),
        block_wire_dtype=knobs.get('block_wire_dtype'))
    art = TuneArtifact(choices, fp, evidence)
  metrics.inc('tune.artifacts')
  if out_path is not None:
    art.save(out_path)
  return art
