"""`tune()`: one call from (dataset, loader_cfg) to a validated
fast-path config artifact.

Counterpart of ``graphlearn_tpu/tune/tuner.py``:

1. **Host probes** (``tune/probes.py``): the calibration simulation for
   frontier caps, in-degree hotness mass for the cache split, the
   divisor ladder for chunk K, planned miss volume for slab caps.
2. **Observatory-scored candidate A/Bs**: each candidate runs a short
   ``ScanTrainer`` compile phase, then a steady epoch. The program
   observatory (``metrics/programs.py``: a CUDA graph capture is the
   port's compile) watches every dispatch site: a candidate whose STEADY
   epoch captures anything is disqualified by construction, and the
   rejection records the signature diff naming the drifted argument.
   Qualified candidates rank by steady wall per step, read after the
   card finished (``torch.cuda.synchronize``, JAX's
   ``block_until_ready``).
3. **Semantics**: ``exact=True`` pins the exact set (calibrated exact
   dedup, f32 wire) and only A/Bs within it; the default also fields the
   certified relaxations (tree dedup, bf16 wire).

Where the port differs, and why:

- **The compile phase.** A capturing ``ScanTrainer`` runs the first
  chunk of its first epoch eagerly (the warm-up that makes Adam's state
  and the kernels' scratch) and captures from the second chunk on. When
  the probe epoch is one chunk long (an epoch of K steps, or of fewer
  than 2K: JAX's ``probe_steps`` is then K), that epoch captures nothing
  and the steady epoch would capture and be rejected. So the compile
  phase runs the probe epoch again while a chunk length the steady epoch
  replays is still uncaptured (at most once more): every chunk length is
  captured before the steady epoch. ``compile_epochs`` records how many
  ran. On the CPU (eager chunks) nothing is ever captured: every
  candidate's compile and steady counts are 0, so a retrace probe is
  only rejected on a card.
- **The tie-break** is always ``'wall'``: JAX's ``GLT_PROGRAM_COST``
  near-tie rule reads XLA's cost analysis, which a capture does not
  carry.
- **The fused-hop variant** is not fielded by default
  (``DEFAULT_FUSED_HOP_WINDOWS = ()``): the port routes its hop kernels
  by device, so the variant would measure the base candidate again.
  The gather-v2 points stay (``use_pallas_v2`` routes the lookups
  through the run-segmented gather, K2).
- **The proxy model** is the port's segment ``GraphSAGE`` (hidden 16,
  weights from seed 0), which runs any layout as flax's layout-free
  proxy does; a caller's ``model`` is deep-copied per candidate (a port
  model owns its weights) and ``tx``, an optimizer, gives the class and
  hyperparameters (``defaults``) of each copy's own optimizer.
- **Memory.** Each candidate's trainer, graphs and loader are released
  before the next is built, and every capturing candidate runs on the
  tuner's one stream (PyTorch keeps a cuBLAS workspace per stream, 65 MB
  on an H100). On a card a record carries ``peak_mb`` and the allocated
  MB before and after (``mem_before_mb``, ``mem_after_mb``).
- **Typed candidates** count a "trace" as a batch whose shape signature
  (``metrics.programs.signature_of``) the step has not seen: what
  ``jax.jit`` retraces on.

The result is a :class:`~graphlearn_tpu_torch.tune.artifact.TuneArtifact`
(JSON on disk via ``out_path=``) that the trainers and the serving
engine accept directly via ``config=``.
"""
import copy
import gc
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import metrics
from ..metrics import programs, spans
from ..utils import strict
from . import probes
from .artifact import (KERNEL_CHOICE_DEFAULTS, TuneArtifact,
                       apply_kernel_routing, dataset_fingerprint)

#: the program sites a local scanned candidate dispatches through —
#: the population the "one capture per chunk length" acceptance counts
CANDIDATE_SITES = ('epoch_seeds', 'scan_chunk', 'metrics_concat')

#: the gather-v2 autotune space (benchmarks/prof_gather2.py's grid) the
#: kernel candidate field draws its grid points from
GATHER2_GRID_BLOCKS = (64, 128, 256, 512)
GATHER2_GRID_SPANS = (1, 4, 8, 16, 32)

#: default kernel-routing grid points fielded per base candidate: the
#: prof_gather2 default (256, 8) plus the small-block point
DEFAULT_GATHER2_POINTS = ((256, 8), (128, 4))

#: default fused-hop window variants fielded: none, the port routes its
#: hop kernels by device (module docstring)
DEFAULT_FUSED_HOP_WINDOWS = ()


class Candidate:
  """One sampling-mode candidate for the observatory A/B.

  Args:
    name: evidence-log label.
    loader_kwargs: NeighborLoader overrides (dedup, frontier_caps,
      padded_window, ...) layered over the shared loader_cfg.
    chunk_k: per-candidate chunk override (None = the probed K).
    exact_semantics: True when the candidate is bit-equivalent to
      exact dedup.
    perturb_chunk: SELF-TEST knob — perturb the chunk length between
      the compile and steady epochs, forcing a steady-state capture;
      the candidate MUST be rejected with the signature diff in the
      evidence log.
    kernel: kernel-routing overrides (KERNEL_CHOICE_KEYS subset)
      applied to the dataset's feature store for this candidate's
      epochs. Keys absent read as the kernels-off defaults, so scoring
      one candidate RESETS the previous candidate's routing.
  """

  def __init__(self, name: str, loader_kwargs: Dict,
               chunk_k: Optional[int] = None,
               exact_semantics: bool = True,
               perturb_chunk: bool = False,
               kernel: Optional[Dict] = None):
    self.name = name
    self.loader_kwargs = dict(loader_kwargs)
    self.chunk_k = chunk_k
    self.exact_semantics = exact_semantics
    self.perturb_chunk = perturb_chunk
    self.kernel = dict(kernel or {})


def retrace_probe_candidate(base: Candidate) -> Candidate:
  """A deliberately retracing copy of ``base`` — the live-fire check
  that the observatory scoring actually rejects a config that captures
  in its steady epoch."""
  return Candidate(f'{base.name}+retrace_probe', base.loader_kwargs,
                   chunk_k=base.chunk_k,
                   exact_semantics=base.exact_semantics,
                   perturb_chunk=True, kernel=base.kernel)


def kernel_candidates(base: Candidate,
                      gather2_points=DEFAULT_GATHER2_POINTS,
                      fused_hop_windows=DEFAULT_FUSED_HOP_WINDOWS
                      ) -> List[Candidate]:
  """Kernel-routing variants of ``base``: the fused-hop windows given
  (none by default: the port routes its hops by device, so such a
  variant carries only the artifact keys), and the run-segmented gather
  v2 at each (block_rows, run_span) grid point. Every variant equals
  ``base`` bit for bit (the kernels' parity contract), so
  ``exact_semantics`` carries over; ties break toward ``base`` (the
  stable sort prefers the earlier, kernels-off field entry)."""
  out = []
  for w in fused_hop_windows:
    if w % 128:
      raise ValueError(f'fused_hop window {w} must be a multiple of '
                       '128 (the lane width — ops/sample_fused.py)')
    out.append(Candidate(
        f'{base.name}+fused_hop_w{w}', base.loader_kwargs,
        chunk_k=base.chunk_k, exact_semantics=base.exact_semantics,
        kernel=dict(use_fused_hop=True, fused_hop_window=int(w))))
  for br, rs in gather2_points:
    if br not in GATHER2_GRID_BLOCKS or rs not in GATHER2_GRID_SPANS:
      raise ValueError(
          f'gather2 grid point ({br}, {rs}) is outside the profiled '
          f'autotune space {GATHER2_GRID_BLOCKS} x {GATHER2_GRID_SPANS} '
          '(benchmarks/prof_gather2.py)')
    out.append(Candidate(
        f'{base.name}+gather2_b{br}r{rs}', base.loader_kwargs,
        chunk_k=base.chunk_k, exact_semantics=base.exact_semantics,
        kernel=dict(use_pallas_v2=True, gather2_block_rows=int(br),
                    gather2_run_span=int(rs))))
  return out


def default_candidates(caps: List[int], exact: bool,
                       kernels: bool = True) -> List[Candidate]:
  """The stock candidate field: calibrated exact dedup always (first —
  the stable-sort tie-break baseline), the tree relaxation unless
  ``exact=True`` pinned the exact set, then the kernel-routing variants
  of the calibrated base (``kernels=False`` drops them)."""
  base = Candidate('map_calibrated',
                   dict(dedup='map', frontier_caps=list(caps)),
                   exact_semantics=True)
  cands = [base]
  if not exact:
    cands.append(Candidate('tree', dict(dedup='tree'),
                           exact_semantics=False))
  if kernels:
    cands.extend(kernel_candidates(base))
  return cands


def _is_hetero_dataset(dataset) -> bool:
  """Typed-dataset dispatch for tune(): hetero datasets route to the
  typed candidate field instead of the homo probe chain."""
  graph = getattr(dataset, 'graph', dataset)
  return isinstance(graph, dict) or \
      bool(getattr(graph, 'is_hetero', False)) or \
      isinstance(getattr(dataset, 'node_features', None), dict)


def hetero_fanout_candidates(fanouts: Dict) -> List:
  """The typed candidate field: the requested per-etype fanout dict as
  the base, plus one per-etype trimmed variant (that edge type's
  per-hop fanouts halved)."""
  from ..typing import as_str
  base = {et: [int(k) for k in f] for et, f in fanouts.items()}
  out = [Candidate('typed_base', dict(fanouts=base))]
  for et in sorted(base, key=str):
    if max(base[et]) <= 1:
      continue  # nothing left to trim on this relation
    trimmed = {e: list(f) for e, f in base.items()}
    trimmed[et] = [max(1, k // 2) for k in base[et]]
    out.append(Candidate(f'trim_{as_str(et)}', dict(fanouts=trimmed)))
  return out


def _refuse_padded_candidates(cands: Sequence[Candidate]):
  """A padded-window config cannot ride the whole-run chunk stream — the
  per-epoch padded-table reseed is a host-side adjacency rebuild
  (NodeLoader._begin_epoch), which RunTrainer refuses for that reason:
  a loud refusal, as JAX's."""
  bad = [c.name for c in cands
         if c.loader_kwargs.get('padded_window') is not None]
  if bad:
    raise ValueError(
        f'tune(): padded-window candidates {bad} are not tunable — '
        'the per-epoch padded-table reseed is a host-side adjacency '
        'rebuild that cannot fold into the whole-run program stream, '
        'so RunTrainer(config=) would refuse the resulting artifact '
        '(loader/run_epoch.py). Drop padded_window from the candidate '
        'field, or hand-tune it for per-epoch ScanTrainer use only '
        '(docs/tuning.md "Padded windows")')


def _norm_cfg(loader_cfg: Dict) -> Dict:
  cfg = dict(loader_cfg)
  if 'fanouts' not in cfg:
    if 'num_neighbors' in cfg:
      cfg['fanouts'] = cfg.pop('num_neighbors')
    else:
      raise ValueError("loader_cfg needs 'fanouts' (the sampler "
                       'fanout list)')
  if 'input_nodes' not in cfg:
    raise ValueError("loader_cfg needs 'input_nodes' (the seed pool)")
  if isinstance(cfg['fanouts'], dict):
    cfg['fanouts'] = {et: [int(k) for k in f]
                      for et, f in cfg['fanouts'].items()}
  else:
    cfg['fanouts'] = [int(k) for k in cfg['fanouts']]
  inp = cfg['input_nodes']
  if isinstance(inp, tuple) and len(inp) == 2 and isinstance(inp[0], str):
    cfg['input_nodes'] = (inp[0], _host(inp[1]).reshape(-1))
  else:
    cfg['input_nodes'] = _host(inp).reshape(-1)
  cfg.setdefault('batch_size', 64)
  cfg.setdefault('shuffle', False)
  cfg.setdefault('drop_last', False)
  cfg.setdefault('seed', 0)
  return cfg


def _host(a) -> np.ndarray:
  """A host numpy view of ids or labels (a tensor on the card is read
  back: tune() runs outside every guarded region)."""
  if torch.is_tensor(a):
    return a.detach().cpu().numpy()
  return np.asarray(a)


def _num_classes(dataset, cfg: Dict) -> int:
  if cfg.get('num_classes'):
    return int(cfg['num_classes'])
  labels = getattr(dataset, 'node_labels', None)
  if isinstance(labels, dict) and isinstance(cfg['input_nodes'], tuple):
    seed_t = cfg['input_nodes'][0]
    if seed_t in labels and labels[seed_t] is not None:
      return int(_host(labels[seed_t]).max()) + 1
  if labels is None or isinstance(labels, dict):
    raise ValueError("pass loader_cfg['num_classes'] — the dataset "
                     'carries no label array for the seed pool to '
                     'infer it from')
  return int(_host(labels).max()) + 1


def _device(dataset) -> torch.device:
  return torch.device(getattr(dataset, 'device', None) or 'cpu')


def _feature_dim(store) -> int:
  from .artifact import _feature_dim as fdim
  d = fdim(store)
  if d is None:
    raise ValueError('tune(): the dataset\'s feature store has no width '
                     'to size the proxy model with; pass model=')
  return int(d)


def _default_model(dataset, cfg: Dict, num_classes: int):
  """The proxy model: the port's segment GraphSAGE (any layout), hidden
  16, weights from seed 0."""
  from ..models import GraphSAGE
  return GraphSAGE(_feature_dim(dataset.node_features), 16, num_classes,
                   num_layers=len(cfg['fanouts']), device=_device(dataset),
                   generator=torch.Generator().manual_seed(0))


def _default_hetero_model(dataset, fanouts: Dict, seed_type: str,
                          num_classes: int):
  # proxy model for typed ranking: the RGNN over reversed relations,
  # logits on the seed type (JAX's proxy)
  from ..models import RGNN
  from ..typing import reverse_edge_type
  etypes = tuple(reverse_edge_type(et) for et in sorted(fanouts))
  layers = max(len(f) for f in fanouts.values())
  in_dims = {t: _feature_dim(s)
             for t, s in dataset.node_features.items()}
  return RGNN(etypes, in_dims, 16, num_classes, num_layers=layers,
              out_ntype=seed_type, device=_device(dataset),
              generator=torch.Generator().manual_seed(0))


def _model_and_state(model, tx, make_default):
  """A candidate's own model and ``TrainState``: a copy of the caller's
  model (or a fresh proxy) and an optimizer of ``tx``'s class and
  hyperparameters over it (default: Adam at 1e-3, optax.adam's rate in
  JAX's tuner)."""
  from ..models import train as train_lib
  mdl = copy.deepcopy(model) if model is not None else make_default()
  if tx is None:
    return mdl, train_lib.create_train_state(mdl, lr=1e-3)
  opt = type(tx)(mdl.parameters(), **tx.defaults)
  return mdl, train_lib.create_train_state(mdl, optimizer=opt)


def _sync(device):
  if device.type == 'cuda':
    with strict.explicit():   # the probe's timing fence: a deliberate sync
      torch.cuda.synchronize(device)


_STREAMS = {}


def _share_stream(trainer):
  """Run a capturing candidate on the tuner's one stream for its device:
  PyTorch keeps a cuBLAS workspace per stream it has seen (65 MB on an
  H100), so a new stream per candidate would pile them up."""
  if not getattr(trainer, 'capture', False) or \
      getattr(trainer, '_stream', 0) is not None:
    return
  dev = torch.device(getattr(trainer, '_device', None) or
                     getattr(trainer, 'device'))
  key = (dev.type, dev.index or 0)
  if key not in _STREAMS:
    _STREAMS[key] = torch.cuda.Stream(dev)
  trainer._stream = _STREAMS[key]


def _mem_mb(device) -> Optional[float]:
  if device.type != 'cuda':
    return None
  return torch.cuda.memory_allocated(device) / 2**20


def _release(device):
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()


def _site_compiles() -> Dict[str, int]:
  return {s: programs.compile_count(s) for s in CANDIDATE_SITES}


def _candidate_record(cand: Candidate, chunk_k: int) -> dict:
  return dict(kind='candidate', name=cand.name,
              loader_kwargs={k: v for k, v in cand.loader_kwargs.items()},
              chunk_k=int(cand.chunk_k or chunk_k),
              exact_semantics=cand.exact_semantics,
              kernel=dict(cand.kernel))


def _chunk_lengths(steps: int, k: int) -> set:
  return {min(k, steps - s) for s in range(0, steps, k)}


def score_candidate(cand: Candidate, dataset, cfg: Dict, num_classes:
                    int, chunk_k: int, probe_steps: Optional[int],
                    model=None, tx=None) -> dict:
  """Run one candidate's compile phase and steady epoch and return its
  evidence record: qualified?, steady wall, per-site capture counts, the
  disqualifying diff (if any), and on a card the peak and allocated MB."""
  from .. import loader as loader_mod
  k = int(cand.chunk_k or chunk_k)
  rec = _candidate_record(cand, chunk_k)
  metrics.inc('tune.candidates')
  t_start = time.perf_counter()
  device = _device(dataset)
  rec['mem_before_mb'] = _mem_mb(device)
  trainer = None
  try:
    with spans.span('tune.candidate', candidate=cand.name, chunk_k=k):
      # stamp THIS candidate's kernel routing on the dataset's feature
      # store (keys absent -> kernels-off defaults, which also resets
      # whatever the previous candidate routed in)
      apply_kernel_routing(dataset, cand.kernel)
      lkw = dict(batch_size=cfg['batch_size'], shuffle=cfg['shuffle'],
                 drop_last=cfg['drop_last'], seed=cfg['seed'],
                 overflow_policy='off', device=device)
      lkw.update(cand.loader_kwargs)
      if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
      loader = loader_mod.NeighborLoader(dataset, cfg['fanouts'],
                                         cfg['input_nodes'], **lkw)
      mdl, state = _model_and_state(
          model, tx, lambda: _default_model(dataset, cfg, num_classes))
      trainer = loader_mod.ScanTrainer(loader, mdl, num_classes,
                                       chunk_size=k)
      _share_stream(trainer)
      steps = trainer._epoch_steps()
      if probe_steps is None:
        probe_steps = min(steps, 2 * k)
      probe_steps = min(steps, max(k, (probe_steps // k) * k))
      base = _site_compiles()
      # compile phase: the capture population is built here, every
      # chunk length the steady epoch replays (module docstring)
      need = _chunk_lengths(probe_steps, k)
      compile_epochs = 0
      while True:
        state, losses, _ = trainer.run_epoch(state, max_steps=probe_steps)
        compile_epochs += 1
        if not trainer.capture or need <= set(trainer._graphs) or \
            compile_epochs == 2:
          break
      _sync(device)
      after_compile = _site_compiles()
      if cand.perturb_chunk:
        # the self-test probe: a mid-run chunk-length drift is exactly
        # the silent production recapture the scoring must catch
        trainer.chunk_size = max(1, k // 2)
      # steady epoch: the measured one — ANY capture here disqualifies
      t0 = time.perf_counter()
      state, losses, _ = trainer.run_epoch(state, max_steps=probe_steps)
      _sync(device)
      wall = time.perf_counter() - t0
      after_steady = _site_compiles()
      rec['probe_steps'] = int(probe_steps)
      rec['compile_epochs'] = compile_epochs
      rec['compile_epoch_compiles'] = {
          s: after_compile[s] - base[s] for s in CANDIDATE_SITES}
      steady = {s: after_steady[s] - after_compile[s]
                for s in CANDIDATE_SITES}
      rec['steady_epoch_compiles'] = steady
      rec['wall_s'] = round(wall, 6)
      if device.type == 'cuda':
        rec['peak_mb'] = torch.cuda.max_memory_allocated(device) / 2**20
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
    # release the candidate's graphs, trainer and loader before the next
    # is built (graph pools otherwise pile up across candidates)
    if trainer is not None:
      trainer._graphs = {}
      trainer._static = None
    trainer = loader = mdl = state = losses = None
    _release(device)
    rec['mem_after_mb'] = _mem_mb(device)
  metrics.observe('tune.probe_ms',
                  (time.perf_counter() - t_start) * 1e3)
  return rec


def score_hetero_candidate(cand: Candidate, dataset, cfg: Dict,
                           num_classes: int, chunk_k: int,
                           probe_steps: Optional[int], model=None,
                           tx=None) -> dict:
  """Run one typed fanout candidate's compile + steady epochs over the
  per-batch typed NeighborLoader and return its evidence record. A
  "trace" is a batch whose shape signature the step has not seen (what
  ``jax.jit`` retraces on): a steady epoch that traces anything means
  the candidate's typed shapes are not closed — disqualified by the same
  rule as the homo path."""
  from .. import loader as loader_mod
  from ..models import train as train_lib
  from ..typing import as_str
  fans = cand.loader_kwargs['fanouts']
  rec = dict(kind='candidate', name=cand.name,
             fanouts={as_str(et): list(f)
                      for et, f in sorted(fans.items(), key=str)},
             chunk_k=int(cand.chunk_k or chunk_k),
             exact_semantics=True, kernel=dict(cand.kernel))
  metrics.inc('tune.candidates')
  t_start = time.perf_counter()
  device = _device(dataset)
  try:
    with spans.span('tune.candidate', candidate=cand.name,
                    chunk_k=int(cand.chunk_k or chunk_k)):
      apply_kernel_routing(dataset, cand.kernel)
      seed_t, seeds = cfg['input_nodes']
      make_loader = lambda: loader_mod.NeighborLoader(
          dataset, fans, (seed_t, seeds),
          batch_size=cfg['batch_size'], shuffle=cfg['shuffle'],
          drop_last=cfg['drop_last'], seed=cfg['seed'], device=device)
      mdl, state = _model_and_state(
          model, tx, lambda: _default_hetero_model(dataset, fans, seed_t,
                                                   num_classes))
      step, _ = train_lib.make_train_step(mdl, num_classes)
      seen = set()
      traces = dict(n=0)
      steps = probes.epoch_steps(seeds.shape[0], cfg['batch_size'],
                                 cfg['drop_last'])
      k = int(cand.chunk_k or chunk_k)
      if probe_steps is None:
        probe_steps = min(steps, 2 * k)
      probe_steps = max(1, min(steps, probe_steps))

      def run_epoch(state):
        for n, b in enumerate(make_loader()):
          if n >= probe_steps:
            break
          batch = train_lib.batch_to_dict(b, ntype=seed_t)
          sig = programs.signature_of((batch,), {})
          if sig not in seen:
            seen.add(sig)
            traces['n'] += 1
          state, _, _ = step(state, batch)
        _sync(device)
        return state

      state = run_epoch(state)  # compile epoch
      after_compile = traces['n']
      t0 = time.perf_counter()
      state = run_epoch(state)  # steady epoch
      wall = time.perf_counter() - t0
      steady = traces['n'] - after_compile
      rec['probe_steps'] = int(probe_steps)
      rec['compile_epoch_compiles'] = dict(hetero_step=after_compile)
      rec['steady_epoch_compiles'] = dict(hetero_step=steady)
      rec['wall_s'] = round(wall, 6)
      rec['qualified'] = steady == 0
      if steady:
        rec['rejected'] = (
            f'steady-state epoch traced {steady} program(s) — a tuned '
            'typed config must dispatch a CLOSED executable set')
        metrics.inc('tune.rejected')
  except Exception as e:  # a broken candidate is evidence, not a crash
    rec['qualified'] = False
    rec['rejected'] = f'{type(e).__name__}: {e}'[:300]
    metrics.inc('tune.rejected')
  finally:
    mdl = state = None
    _release(device)
  metrics.observe('tune.probe_ms',
                  (time.perf_counter() - t_start) * 1e3)
  return rec


def _per_step_wall(rec: dict) -> float:
  # candidates with different chunk_k run different probe_steps (each
  # epoch rounds to its own chunk boundary) — raw wall_s would compare
  # apples to oranges, so ranking normalizes to wall per step
  return rec['wall_s'] / max(1, rec.get('probe_steps', 1))


def _pick_winner(records: List[dict]) -> dict:
  """The qualified record of least steady wall per step (the stable sort
  keeps field order on ties); the tie-break is the wall only."""
  ok = [r for r in records if r.get('qualified')]
  if not ok:
    raise RuntimeError(
        'tune(): every candidate was disqualified — see the evidence '
        'log on the raised artifact draft for per-candidate reasons '
        f'({[r.get("rejected") for r in records]})')
  ok.sort(key=_per_step_wall)
  return ok[0]


def tune(dataset, loader_cfg: Dict, *, topology: str = 'local',
         exact: bool = False,
         candidates: Optional[Sequence[Candidate]] = None,
         probe_steps: Optional[int] = None, model=None, tx=None,
         num_probes: int = 8, seed: int = 0,
         budget_s: Optional[float] = None,
         out_path: Optional[str] = None) -> TuneArtifact:
  """One call from a dataset + loader shape to a validated config
  artifact (module docstring).

  Args:
    dataset: a homogeneous ``data.Dataset`` with features + labels (on
      the card unless built with ``device='cpu'``; the candidates run
      where it lives). For distributed topologies: the scenario's
      dataset, used for the fingerprint; the scenarios come from
      ``loader_cfg['make_scenario']``.
    loader_cfg: dict with ``fanouts``, ``input_nodes``, ``batch_size``
      (+ optional shuffle / drop_last / seed / num_classes). For
      ``topology != 'local'`` see :func:`tune.topology.tune_topology`.
    topology: ``'local'`` (ScanTrainer, the default), ``'dist'``,
      ``'remote'`` or ``'tiered_dist'``.
    exact: pin the exact-semantics set.
    candidates: explicit candidate list (default:
      :func:`default_candidates`; append
      :func:`retrace_probe_candidate` to live-fire the rejection path).
    probe_steps: optimizer steps per A/B epoch (default ``2 x K``,
      rounded to a chunk boundary).
    model / tx: the model (copied per candidate) and an optimizer whose
      class and ``defaults`` each copy's optimizer takes (default: the
      proxy GraphSAGE and Adam at 1e-3).
    num_probes / seed: calibration probe controls (calibrate.py).
    budget_s: wall-clock budget for the candidate A/Bs: after the first
      candidate, the remaining ladder is truncated to what the budget
      affords at its measured wall, with a ``kind='budget'`` record.
    out_path: also save the artifact JSON there.
  """
  if topology != 'local':
    from .topology import tune_topology
    return tune_topology(topology, dataset, loader_cfg, exact=exact,
                         candidates=candidates,
                         probe_steps=probe_steps, budget_s=budget_s,
                         out_path=out_path)
  cfg = _norm_cfg(loader_cfg)
  if _is_hetero_dataset(dataset):
    return _tune_hetero_local(dataset, cfg, exact=exact,
                              candidates=candidates,
                              probe_steps=probe_steps, model=model,
                              tx=tx, budget_s=budget_s,
                              out_path=out_path)
  num_classes = _num_classes(dataset, cfg)
  evidence: List[dict] = []
  with spans.span('tune.run', exact=exact):
    caps, ev = probes.probe_frontier_caps(
        dataset.graph, cfg['fanouts'], cfg['batch_size'],
        input_nodes=cfg['input_nodes'], num_probes=num_probes,
        seed=seed)
    evidence.append(ev)
    n = dataset.graph.topo.indptr.shape[0] - 1 \
        if hasattr(dataset.graph, 'topo') else \
        np.asarray(dataset.graph.indptr).shape[0] - 1
    split, bucket_frac, ev = probes.probe_cache_split(dataset.graph, n)
    evidence.append(ev)
    steps = probes.epoch_steps(cfg['input_nodes'].shape[0],
                               cfg['batch_size'], cfg['drop_last'])
    chunk_k, ev = probes.probe_chunk_k(steps)
    evidence.append(ev)
    slab_cap, ev = probes.probe_slab_cap(chunk_k, caps,
                                         cfg['batch_size'], split)
    evidence.append(ev)
    buckets, ev = probes.probe_serving_buckets(cfg['batch_size'])
    evidence.append(ev)
    wire, ev = probes.wire_dtype_choice(exact)
    evidence.append(ev)

    cands = list(candidates) if candidates is not None \
        else default_candidates(caps, exact)
    _refuse_padded_candidates(cands)
    if exact:
      dropped = [c.name for c in cands if not c.exact_semantics]
      cands = [c for c in cands if c.exact_semantics]
      if dropped:
        evidence.append(dict(
            kind='exact_pin', dropped_candidates=dropped,
            note='exact=True pins the accuracy-matrix exact set'))
    records = []
    pending = list(cands)
    while pending:
      cand = pending.pop(0)
      records.append(score_candidate(cand, dataset, cfg, num_classes,
                                     chunk_k, probe_steps, model=model,
                                     tx=tx))
      if budget_s is not None and len(records) == 1 and pending:
        from .topology import _budget_ladder
        pending, ev = _budget_ladder(records, pending, budget_s,
                                     records[0].get('wall_s') or 0.0)
        evidence.append(ev)
    evidence.extend(records)
    best = _pick_winner(records)
    kern = dict(KERNEL_CHOICE_DEFAULTS)
    kern.update(best.get('kernel') or {})
    evidence.append(dict(kind='winner', name=best['name'],
                         wall_s=best['wall_s'],
                         tie_break=best.get('tie_break', 'wall'),
                         kernel=dict(kern)))
    # leave the dataset routed the way the winner ran (score_candidate
    # stamped the LAST candidate's routing, not necessarily the best's)
    apply_kernel_routing(dataset, kern)

    choices = dict(
        mode=best['loader_kwargs'].get('dedup', 'map'),
        frontier_caps=list(caps),
        padded_window=best['loader_kwargs'].get('padded_window'),
        wire_dtype=wire,
        chunk_k=int(best['chunk_k']),
        split_ratio=split,
        bucket_frac=bucket_frac,
        slab_cap=int(slab_cap),
        serving_buckets=list(buckets),
        batch_size=int(cfg['batch_size']),
        fanouts=list(cfg['fanouts']),
        exact=bool(exact))
    choices.update(kern)
    fp = dataset_fingerprint(dataset)
    if fp is None:
      evidence.append(dict(
          kind='fingerprint_gap', topology='local',
          dataset_type=type(dataset).__name__,
          note='dataset has no computable fingerprint — config= '
               'acceptors will warn instead of validating '
               '(docs/tuning.md "Fingerprints")'))
    art = TuneArtifact(choices, fp, evidence)
  metrics.inc('tune.artifacts')
  if out_path is not None:
    art.save(out_path)
  return art


def _tune_hetero_local(dataset, cfg: Dict, *, exact: bool,
                       candidates: Optional[Sequence[Candidate]],
                       probe_steps: Optional[int], model, tx,
                       budget_s: Optional[float],
                       out_path: Optional[str]) -> TuneArtifact:
  """tune() over a typed dataset: field the per-etype fanout candidate
  ladder, score each by compile + steady per-batch epochs with the RGNN
  proxy, and sign the winner into a v3 artifact with the TYPED dataset
  fingerprint."""
  if not isinstance(cfg['fanouts'], dict):
    raise ValueError(
        "tune() on a typed dataset needs loader_cfg['fanouts'] as an "
        '{edge_type: [per-hop counts]} dict — the per-etype closed '
        'shapes are the thing being tuned (docs/capacity_plans.md)')
  if not isinstance(cfg['input_nodes'], tuple):
    raise ValueError(
        "tune() on a typed dataset needs loader_cfg['input_nodes'] as "
        "('ntype', ids) — the seed type picks the label store and the "
        'proxy head (docs/tuning.md "Hetero datasets")')
  num_classes = _num_classes(dataset, cfg)
  evidence: List[dict] = []
  with spans.span('tune.run', exact=exact, hetero=True):
    seed_t, seeds = cfg['input_nodes']
    steps = probes.epoch_steps(seeds.shape[0], cfg['batch_size'],
                               cfg['drop_last'])
    chunk_k, ev = probes.probe_chunk_k(steps)
    evidence.append(ev)
    buckets, ev = probes.probe_serving_buckets(cfg['batch_size'])
    evidence.append(ev)
    wire, ev = probes.wire_dtype_choice(exact)
    evidence.append(ev)

    cands = list(candidates) if candidates is not None \
        else hetero_fanout_candidates(cfg['fanouts'])
    records: List[dict] = []
    pending = list(cands)
    while pending:
      cand = pending.pop(0)
      records.append(score_hetero_candidate(
          cand, dataset, cfg, num_classes, chunk_k, probe_steps,
          model=model, tx=tx))
      if budget_s is not None and len(records) == 1 and pending:
        from .topology import _budget_ladder
        pending, ev = _budget_ladder(records, pending, budget_s,
                                     records[0].get('wall_s') or 0.0)
        evidence.append(ev)
    evidence.extend(records)
    best = _pick_winner(records)
    evidence.append(dict(kind='winner', name=best['name'],
                         wall_s=best['wall_s'],
                         tie_break=best.get('tie_break', 'wall'),
                         fanouts=dict(best['fanouts'])))
    choices = dict(
        mode='map',  # the typed engine runs the exact-dedup path
        frontier_caps=None,  # typed caps live in the CapacityPlan
        padded_window=None,
        wire_dtype=wire,
        chunk_k=int(chunk_k),
        serving_buckets=list(buckets),
        batch_size=int(cfg['batch_size']),
        fanouts={k: list(v) for k, v in best['fanouts'].items()},
        exact=bool(exact))
    fp = dataset_fingerprint(dataset)
    art = TuneArtifact(choices, fp, evidence)
  metrics.inc('tune.artifacts')
  if out_path is not None:
    art.save(out_path)
  return art
