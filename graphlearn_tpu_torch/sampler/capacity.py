"""CapacityPlan: the per-ntype / per-etype closed-shape artifact.

Counterpart of ``graphlearn_tpu/sampler/capacity.py`` (host Python and
numpy, so the same code). Per node type and edge type it holds the
frontier caps per hop, the padded row counts, the wire key set, the
PRNG draw count per batch and the analytic byte budgets, computed once
from the sampler configuration and read by the consumers: the typed
engines (``hetero_capacity_plan`` is what the plan wraps; a homogeneous
sampler gives the single-ntype degenerate plan), the block frames, the
distributed stagers and the tuner. A consumer that cannot build a plan
raises :class:`CapacityPlanError`, naming the consumer, the missing
input and ``docs/capacity_plans.md``.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..typing import as_str, reverse_edge_type

#: the degenerate node type homo plans use — one ntype, one implicit
#: etype; every typed consumer treats homo as this single-entry plan
DEFAULT_NTYPE = '_N'
DEFAULT_ETYPE = (DEFAULT_NTYPE, '_E', DEFAULT_NTYPE)

DOC_ANCHOR = 'docs/capacity_plans.md'


class CapacityPlanError(ValueError):
  """A consumer needed a CapacityPlan it could not build.

  Always names the consumer, the missing input, and the doc anchor —
  replacing the bare ``ValueError`` homo-only guards this repo used to
  scatter (storage/dist_scan.py, distributed/block_producer.py).
  """

  def __init__(self, consumer: str, missing: str, hint: str = ''):
    self.consumer = consumer
    self.missing = missing
    msg = (f'{consumer} needs a CapacityPlan but {missing}'
           f'{" — " + hint if hint else ""} (see {DOC_ANCHOR})')
    super().__init__(msg)


def _et_str(et) -> str:
  return as_str(tuple(et))


@dataclass(frozen=True)
class CapacityPlan:
  """Per-ntype/etype closed shapes for one (sampler config, batch cap).

  ``hop_caps[h][et] = (fcap, k, ecap)``: at hop ``h``, edge type ``et``
  expands a source frontier of at most ``fcap`` nodes by fanout ``k``
  into at most ``ecap`` new unique nodes (the calibrated clamp; equals
  ``fcap * k`` unclamped). ``node_caps[t]`` is node type ``t``'s total
  padded row count — the feature-gather width, the per-ntype exchange
  slab request width, and the block frame's ``x.{t}`` leading axis.
  ``edge_caps[oet]`` is OUT-facing edge type ``oet``'s total padded
  edge rows (the ``row.{oet}``/``col.{oet}`` frame width).
  """
  ntypes: Tuple[str, ...]
  etypes: Tuple[Tuple[str, str, str], ...]   # canonical sorted input ets
  edge_dir: str
  seed_caps: Dict[str, int]
  hop_caps: Tuple[Dict[Tuple[str, str, str], Tuple[int, int, int]], ...]
  node_caps: Dict[str, int]
  input_type: Optional[str] = None
  wire_dtype: Optional[str] = None
  metadata: dict = field(default_factory=dict, compare=False)

  # ------------------------------------------------------------ derived

  @property
  def num_hops(self) -> int:
    return len(self.hop_caps)

  @property
  def is_hetero(self) -> bool:
    return self.ntypes != (DEFAULT_NTYPE,)

  @property
  def batch_cap(self) -> int:
    t = self.input_type or DEFAULT_NTYPE
    return int(self.seed_caps.get(t, 0))

  def out_etypes(self) -> List[Tuple[str, str, str]]:
    """OUT-facing edge types in first-touched order — the engines emit
    edge blocks under ``reverse_edge_type(et)`` when edge_dir='out'."""
    out = []
    for per_et in self.hop_caps:
      for et in per_et:
        oet = reverse_edge_type(et) if self.edge_dir == 'out' else et
        if oet not in out:
          out.append(oet)
    return out

  @property
  def edge_caps(self) -> Dict[Tuple[str, str, str], int]:
    """Total padded edge rows per OUT-facing edge type: the engines
    append one ``fcap * k`` block per (hop, etype) touch and
    concatenate, so the frame width is the sum over hops."""
    caps: Dict[Tuple[str, str, str], int] = {}
    for per_et in self.hop_caps:
      for et, (fcap, k, _ecap) in per_et.items():
        oet = reverse_edge_type(et) if self.edge_dir == 'out' else et
        caps[oet] = caps.get(oet, 0) + fcap * k
    return caps

  @property
  def key_draws_per_batch(self) -> int:
    """Host PRNG fold_in draws one batch consumes: the homo engine
    draws one key per batch; the hetero engine draws one per (hop,
    etype) touch. Counter-addressed replay (block producers, failover)
    multiplies batch indices by THIS, so random access lands on the
    same stream positions the sequential per-batch loaders use."""
    if not self.is_hetero:
      return 1
    return sum(len(per_et) for per_et in self.hop_caps)

  def feat_types(self, available=None) -> List[str]:
    """Node types carrying rows (node_caps > 0), intersected with the
    store keys when given — the deterministic per-ntype order every
    consumer (frame keys, slab threading, collate bodies) shares."""
    ts = [t for t in sorted(self.ntypes) if self.node_caps.get(t, 0) > 0]
    if available is not None:
      ts = [t for t in ts if t in available]
    return ts

  # ---------------------------------------------------------- wire view

  def frame_keys(self, feat_types=None) -> List[str]:
    """The closed key set of one block frame under this plan (the
    typed-flat SampleMessage convention, distributed/message.py)."""
    if not self.is_hetero:
      keys = ['node', 'num_nodes', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges', 'x', 'y']
      return keys
    keys = ['#META.hetero', '#META.batch_size', '#META.input_type']
    for t in self.feat_types():
      keys += [f'node.{t}', f'num_nodes.{t}', f'num_sampled_nodes.{t}']
    for oet in self.out_etypes():
      s = _et_str(oet)
      keys += [f'row.{s}', f'col.{s}', f'edge_mask.{s}',
               f'num_sampled_edges.{s}']
    for t in (feat_types if feat_types is not None else self.feat_types()):
      keys.append(f'x.{t}')
    if self.input_type is not None:
      keys += [f'batch.{self.input_type}', f'y.{self.input_type}']
    return keys

  def block_mb_per_chunk(self, k: int, feat_dims: Dict[str, int],
                         edge_id_bytes: int = 4) -> float:
    """Analytic wire size of one K-batch block frame under this plan —
    the typed generalization of ``block_mb_per_chunk`` the topology
    tuner screens candidates with."""
    feat_bytes = 2 if self.wire_dtype in ('bf16', 'bfloat16') else 4
    total = 0
    for t, cap in self.node_caps.items():
      f = feat_dims.get(t, 0)
      total += cap * f * feat_bytes      # x rows
      total += cap * edge_id_bytes      # node ids
    for _oet, ecap in self.edge_caps.items():
      total += ecap * 3 * edge_id_bytes  # row + col + mask
    b = self.batch_cap
    total += b * 2 * edge_id_bytes       # batch ids + labels
    return k * total / 1e6

  def slab_caps_upper(self, hot_prefix_rows: Dict[str, int],
                      chunk_size: int) -> Dict[str, int]:
    """Per-ntype upper bound on a chunk's staged-slab capacity: at most
    ``chunk_size * node_caps[t]`` distinct rows can miss the hot prefix
    in one chunk (the planner pads the actual miss count to pow2 and
    never exceeds this)."""
    out = {}
    for t in self.feat_types():
      h = int(hot_prefix_rows.get(t, 0))
      cap = chunk_size * int(self.node_caps[t])
      out[t] = 0 if h <= 0 else cap
    return out

  # --------------------------------------------------------- tune view

  def fingerprint_payload(self) -> dict:
    """Canonical JSON-able view for tune artifacts: the shapes a tuned
    choice set was measured under. Etype keys are stringified so the
    payload round-trips through JSON unchanged."""
    return {
        'ntypes': list(self.ntypes),
        'etypes': [_et_str(et) for et in self.etypes],
        'edge_dir': self.edge_dir,
        'input_type': self.input_type,
        'seed_caps': {t: int(v) for t, v in sorted(self.seed_caps.items())},
        'node_caps': {t: int(v) for t, v in sorted(self.node_caps.items())},
        'hop_caps': [
            {_et_str(et): [int(x) for x in caps]
             for et, caps in sorted(per_et.items())}
            for per_et in self.hop_caps],
        'key_draws_per_batch': int(self.key_draws_per_batch),
        'wire_dtype': self.wire_dtype,
    }

  # ------------------------------------------------------- constructors

  @classmethod
  def homo(cls, batch_cap: int, fanouts, node_budget=None,
           frontier_caps=None, wire_dtype=None) -> 'CapacityPlan':
    """The single-ntype degenerate plan: the homogeneous
    ``capacity_plan`` chain re-expressed as a one-ntype, one-etype
    CapacityPlan so typed consumers need no homo special case."""
    from .neighbor_sampler import capacity_plan
    caps = capacity_plan(int(batch_cap), tuple(fanouts),
                         node_budget=node_budget,
                         frontier_caps=frontier_caps)
    hop_caps = []
    for i, k in enumerate(fanouts):
      hop_caps.append({DEFAULT_ETYPE: (int(caps[i]), int(k),
                                       int(caps[i + 1]))})
    # merge-style occupancy (clamped contributions accumulate), matching
    # hetero_capacity_plan's node_caps arithmetic exactly
    node_cap = int(sum(caps))
    return cls(ntypes=(DEFAULT_NTYPE,), etypes=(DEFAULT_ETYPE,),
               edge_dir='out', seed_caps={DEFAULT_NTYPE: int(batch_cap)},
               hop_caps=tuple(hop_caps),
               node_caps={DEFAULT_NTYPE: node_cap},
               input_type=None, wire_dtype=wire_dtype,
               metadata={'caps': [int(c) for c in caps]})

  @classmethod
  def hetero(cls, etypes, fanouts_of, seed_caps, edge_dir,
             etype_caps=None, input_type=None,
             wire_dtype=None) -> 'CapacityPlan':
    """Typed plan over ``hetero_capacity_plan`` — the same kernel the
    engines trace, reified with its inputs. ``fanouts_of`` is either
    the engines' accessor (etype -> per-hop fanouts) or a plain
    per-etype dict."""
    from .neighbor_sampler import hetero_capacity_plan
    if not callable(fanouts_of):
      fans = {tuple(et): [int(k) for k in v]
              for et, v in fanouts_of.items()}
      fanouts_of = lambda et: fans[tuple(et)]  # noqa: E731
    ets = tuple(sorted(tuple(et) for et in etypes))
    ntypes, hop_caps, node_caps = hetero_capacity_plan(
        ets, fanouts_of, dict(seed_caps), edge_dir,
        etype_caps=etype_caps)
    return cls(ntypes=tuple(sorted(ntypes)), etypes=ets,
               edge_dir=edge_dir,
               seed_caps={t: int(v) for t, v in seed_caps.items()},
               hop_caps=tuple(hop_caps),
               node_caps={t: int(v) for t, v in node_caps.items()},
               input_type=input_type, wire_dtype=wire_dtype)

  @classmethod
  def from_sampler(cls, sampler, batch_cap: int, input_type=None,
                   wire_dtype=None) -> 'CapacityPlan':
    """Plan for one sampler + seed batch — hetero when the sampler is,
    else the degenerate homo plan. The one constructor consumers call
    (block producers, tiered stagers, tune probes)."""
    if getattr(sampler, 'is_hetero', False):
      if input_type is None:
        raise CapacityPlanError(
            'CapacityPlan.from_sampler', 'typed seeds carry no '
            'input_type', 'pass input_type (the seed node type)')
      g = sampler.graph
      etypes = list(g.etypes) if hasattr(g, 'etypes') else list(g.keys())
      return cls.hetero(
          etypes, sampler._etype_fanouts, {input_type: int(batch_cap)},
          sampler.edge_dir, etype_caps=sampler.frontier_caps,
          input_type=input_type, wire_dtype=wire_dtype)
    return cls.homo(batch_cap, tuple(sampler.num_neighbors),
                    node_budget=getattr(sampler, 'node_budget', None),
                    frontier_caps=getattr(sampler, 'frontier_caps', None),
                    wire_dtype=wire_dtype)

  # -------------------------------------------------------- engine view

  def engine_plan(self):
    """The raw ``(num_hops, hop_caps, node_caps)`` triple the typed
    engines consume (``_hetero_engine`` / ``_hetero_plan`` shape)."""
    return (self.num_hops,
            [dict(per_et) for per_et in self.hop_caps],
            dict(self.node_caps))


def ack_edge_ids(frame: dict, step: int) -> Optional[np.ndarray]:
  """Chunk-granular LINK ack provenance: the seed edge (src, dst) pairs
  batch ``step`` of a block frame covered — ``None`` on node frames.
  Edge frames carry ``#META.edge_batch`` [k, 2, b] and
  ``#META.edge_batch_size`` [k] (block_producer link frames), so a
  failover replay can account every seed EDGE exactly once, the same
  record node epochs get from ``batch``."""
  if '#META.edge_batch' not in frame:
    return None
  eb = np.asarray(frame['#META.edge_batch'][step])
  n = int(np.asarray(frame['#META.edge_batch_size'][step]).reshape(-1)[0])
  return eb[:, :n]
