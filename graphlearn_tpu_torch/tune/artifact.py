"""The tuned-config artifact: a versioned, fingerprinted, evidence-
carrying JSON record of every fast-path knob `tune()` chose.

Counterpart of ``graphlearn_tpu/tune/artifact.py``, with the same schema
(version 3, and the v1 and v2 upgrade paths), the same closed knob set,
the same dataset fingerprint and the same whole-artifact sha1, so a file
either package writes loads, validates and drives the other's
constructors. An artifact pins one consistent assignment of every knob
(dedup mode, frontier caps, padded window, cache split, wire dtype, scan
chunk K, staging slab caps, serving buckets, the gather-kernel routing,
the topology), together with:

* a **dataset fingerprint** (node and edge counts, feature dim, a sha1 of
  the degree sequence and of a strided sample of the adjacency; per edge
  type on a typed dataset, per shard plus the partition book on a
  distributed one), computed from host arrays only: the ``config=``
  acceptors (``ScanTrainer``, ``RunTrainer``, ``DistScanTrainer``,
  ``TieredScanTrainer``, ``TieredDistScanTrainer``,
  ``RemoteScanTrainer``, ``ServingEngine``) refuse a drifted dataset;
* an **evidence log**: for every knob the probe that chose it and the
  measured values, and for each candidate A/B the observatory's verdict
  (a candidate whose steady epoch captured a chunk graph is recorded as
  rejected with the signature diff naming the drifted argument);
* a whole-artifact sha1 **fingerprint** over (version, dataset,
  choices), so a hand-edited file is refused at load.

The kernel-routing keys keep JAX's names: ``use_pallas_v2`` with
``gather2_block_rows`` / ``gather2_run_span`` routes the feature and
embedding lookups through the port's run-segmented gather
(``ops.gather_rows_hbm2``, ``csrc/gather_runs.cu``) at that grid point.
``use_fused_hop`` / ``fused_hop_window`` load and round-trip, but the
port routes its hop kernels by device, so no loader kwarg carries them
(``loader_kwargs`` never emits them).
"""
import hashlib
import json
from typing import Any, Dict, List, Optional

import numpy as np

#: bump when the schema changes shape (loaders refuse unknown versions;
#: versions 1/2 — pre-kernel-routing / pre-topology — load with the
#: documented defaults via the per-version upgrade path below)
ARTIFACT_VERSION = 3

#: version 1's closed knob set — a v1 file is validated against THIS
#: set (and its own version-1 fingerprint) before the upgrade path
#: fills in the kernel-routing keys it predates
_V1_CHOICE_KEYS = frozenset({
    'mode', 'frontier_caps', 'padded_window', 'wire_dtype', 'chunk_k',
    'split_ratio', 'bucket_frac', 'slab_cap', 'serving_buckets',
    'batch_size', 'fanouts', 'exact',
})

#: the kernel-routing knobs added in schema version 2 (docs/tuning.md
#: 'Kernel candidates'): which kernel routes the observatory A/Bs
#: selected, and their grid points (benchmarks/prof_gather2.py space)
KERNEL_CHOICE_KEYS = frozenset({
    'use_pallas_v2', 'gather2_block_rows', 'gather2_run_span',
    'use_fused_hop', 'fused_hop_window',
})

#: the defaults a choices dict missing kernel keys (hand-built, or a
#: version-1 artifact on the upgrade path) is completed with: KERNELS
#: OFF — routing a kernel in is an evidence-backed choice, never an
#: implicit one
KERNEL_CHOICE_DEFAULTS = {
    'use_pallas_v2': False, 'gather2_block_rows': 256,
    'gather2_run_span': 8, 'use_fused_hop': False,
    'fused_hop_window': 512,
}

#: version 2's closed knob set — v1 plus kernel routing; a v2 file is
#: validated against THIS set (and its own version-2 fingerprint)
#: before the upgrade path fills in the topology keys it predates
_V2_CHOICE_KEYS = _V1_CHOICE_KEYS | KERNEL_CHOICE_KEYS

#: the per-topology knobs added in schema version 3 (docs/tuning.md
#: 'Topology candidates'): which trainer scenario the artifact was
#: tuned FOR, plus the scenario knobs only that topology consumes
#: (remote block streams, tiered hot prefix)
TOPOLOGY_CHOICE_KEYS = frozenset({
    'topology', 'hot_prefix_rows', 'block_ahead', 'block_wire_dtype',
})

#: defaults for a choices dict missing topology keys (hand-built, or a
#: version-1/2 artifact on the upgrade path): a LOCAL artifact — the
#: pre-v3 tuner only ever scored the homo local-scan path, so that is
#: exactly what an upgraded file's choices were measured on
TOPOLOGY_CHOICE_DEFAULTS = {
    'topology': 'local', 'hot_prefix_rows': None, 'block_ahead': None,
    'block_wire_dtype': None,
}

#: the knob set every artifact carries (docs/tuning.md knob table) —
#: a choices dict is validated against this closed set on load
CHOICE_KEYS = _V2_CHOICE_KEYS | TOPOLOGY_CHOICE_KEYS

#: each schema version's own closed knob set — from_json validates a
#: file against ITS version's set (and its own fingerprint) before any
#: upgrade fills in the keys that version predates
_VERSION_CHOICE_KEYS = {
    1: _V1_CHOICE_KEYS,
    2: _V2_CHOICE_KEYS,
    3: CHOICE_KEYS,
}


def _csr_fingerprint(graph) -> Optional[Dict[str, Any]]:
  """Identity of ONE CSR (local Graph/Topology or stacked DistGraph):
  shape counts plus a sha1 of the degree sequence — host-side arrays
  only, never a device fetch (the calibrate.py convention)."""
  src = getattr(graph, 'topo', graph)
  indptr = getattr(src, 'indptr', None)
  if indptr is None:
    return None
  indptr = np.asarray(indptr, np.int64)
  if indptr.ndim == 2:
    # stacked sharded partitions (distributed DistGraph, [P, r_max+1]):
    # fingerprint the per-shard degree sequences plus the partition
    # book — the identity a dist/tiered topology artifact is tuned FOR
    # (a repartition or a node-ownership change both shift the
    # exchange volumes every dist knob was measured against)
    deg = np.diff(indptr, axis=1)
    fp = dict(
        num_partitions=int(indptr.shape[0]),
        degree_sha1=hashlib.sha1(
            np.ascontiguousarray(deg).tobytes()).hexdigest()[:16])
    node_pb = getattr(graph, 'node_pb', None)
    if node_pb is not None and not isinstance(node_pb, dict):
      node_pb = np.asarray(node_pb, np.int64)
      fp['num_nodes'] = int(node_pb.shape[0])
      fp['node_pb_sha1'] = hashlib.sha1(
          np.ascontiguousarray(node_pb).tobytes()).hexdigest()[:16]
    return fp
  deg = np.diff(indptr)
  fp = dict(
      num_nodes=int(indptr.shape[0] - 1),
      num_edges=int(indptr[-1]),
      degree_sha1=hashlib.sha1(
          np.ascontiguousarray(deg).tobytes()).hexdigest()[:16])
  indices = getattr(src, 'indices', None)
  if indices is not None:
    # degree sequences alone can collide (a regular graph rewires
    # without changing any degree) — fold in a deterministic strided
    # sample of the adjacency targets, bounded at ~1M entries so the
    # fingerprint stays O(1M) work at any graph scale
    idx = np.asarray(indices)
    stride = max(1, idx.shape[0] // 1_000_000)
    fp['edges_sha1'] = hashlib.sha1(
        np.ascontiguousarray(idx[::stride].astype(np.int64))
        .tobytes()).hexdigest()[:16]
  return fp


def _feature_dim(store) -> Optional[int]:
  fdim = getattr(store, 'feature_dim', None)
  if fdim is not None:
    return int(fdim)
  shape = getattr(store, 'shape', None)
  if shape is not None and len(shape) > 1:
    return int(shape[1])
  return None


def _hetero_fingerprint(dataset, graph) -> Optional[Dict[str, Any]]:
  """Typed dataset identity: one per-etype CSR fingerprint (local dict
  graphs and DistHeteroGraph sub-CSRs alike) plus per-ntype partition
  books and feature dims — the identity a hetero CapacityPlan's closed
  shapes are derived from (docs/capacity_plans.md)."""
  from ..typing import as_str
  subs = graph if isinstance(graph, dict) else \
      getattr(graph, 'sub', None)
  if not subs:
    return None
  etypes = {}
  for et in sorted(subs, key=str):
    sub_fp = _csr_fingerprint(subs[et])
    if sub_fp is not None:
      etypes[as_str(et) if isinstance(et, tuple) else str(et)] = sub_fp
  if not etypes:
    return None
  fp: Dict[str, Any] = dict(hetero=True, etypes=etypes)
  node_pb = getattr(graph, 'node_pb', None)
  if isinstance(node_pb, dict):
    fp['num_partitions'] = int(getattr(graph, 'num_partitions', 0))
    fp['num_nodes'] = {str(t): int(np.asarray(pb).shape[0])
                       for t, pb in sorted(node_pb.items())}
    fp['node_pb_sha1'] = {
        str(t): hashlib.sha1(
            np.ascontiguousarray(np.asarray(pb, np.int64))
            .tobytes()).hexdigest()[:16]
        for t, pb in sorted(node_pb.items())}
  feats = getattr(dataset, 'node_features', None)
  if isinstance(feats, dict):
    dims = {str(t): _feature_dim(s) for t, s in sorted(feats.items())}
    dims = {t: d for t, d in dims.items() if d is not None}
    if dims:
      fp['feature_dim'] = dims
  return fp


def dataset_fingerprint(dataset) -> Optional[Dict[str, Any]]:
  """Identity of the graph a config was tuned FOR: shape counts plus a
  sha1 of the degree sequence per CSR (the host-side Topology arrays —
  never a device fetch, the calibrate.py convention). Hetero datasets
  (dict graphs, DistHeteroGraph) fingerprint TYPED: one record per
  edge type plus per-ntype partition books and feature dims, so a
  hetero artifact validates on load exactly like a homo one. Returns
  None only when the dataset carries no graph structure at all —
  validation then degrades to a warning, never a spurious refusal."""
  graph = getattr(dataset, 'graph', dataset)
  if graph is None:
    return None
  if isinstance(graph, dict) or getattr(graph, 'is_hetero', False):
    return _hetero_fingerprint(dataset, graph)
  fp = _csr_fingerprint(graph)
  if fp is None:
    return None
  feats = getattr(dataset, 'node_features', None)
  if feats is not None and not isinstance(feats, dict):
    fdim = _feature_dim(feats)
    if fdim is not None:
      fp['feature_dim'] = int(fdim)
  return fp


def _canonical(obj) -> str:
  return json.dumps(obj, sort_keys=True, separators=(',', ':'),
                    default=str)


def compute_fingerprint(version: int, dataset_fp: Optional[dict],
                        choices: dict) -> str:
  payload = dict(version=version, dataset=dataset_fp, choices=choices)
  return hashlib.sha1(_canonical(payload).encode()).hexdigest()


class TuneArtifact:
  """One tuned configuration + the evidence that chose it.

  Attributes:
    choices: the knob assignment (CHOICE_KEYS; docs/tuning.md table).
    dataset: the dataset fingerprint the config was tuned for.
    evidence: list of probe/candidate records — each names the knob(s)
      it informed, the measured values, and (for candidate A/Bs) the
      observatory verdict: compiles / retraces / the disqualifying
      signature diff / cost attribution / steady-state wall.
    fingerprint: sha1 over (version, dataset, choices).
  """

  def __init__(self, choices: Dict[str, Any],
               dataset: Optional[Dict[str, Any]] = None,
               evidence: Optional[List[dict]] = None):
    unknown = set(choices) - CHOICE_KEYS
    if unknown:
      raise ValueError(f'unknown choice keys {sorted(unknown)} — the '
                       f'artifact knob set is closed (docs/tuning.md)')
    self.version = ARTIFACT_VERSION
    self.choices = dict(choices)
    # kernel-routing and topology keys are part of the closed v3 set:
    # complete a partial dict with the documented defaults (kernels
    # off, local topology) so the fingerprint is a function of the
    # FULL assignment
    for key, default in KERNEL_CHOICE_DEFAULTS.items():
      self.choices.setdefault(key, default)
    for key, default in TOPOLOGY_CHOICE_DEFAULTS.items():
      self.choices.setdefault(key, default)
    topo = self.choices['topology']
    if topo not in ('local', 'dist', 'remote', 'tiered_dist'):
      raise ValueError(f'unknown topology {topo!r} — the artifact '
                       "topology set is closed ('local', 'dist', "
                       "'remote', 'tiered_dist'; docs/tuning.md)")
    self.dataset = dict(dataset) if dataset is not None else None
    self.evidence = list(evidence or [])
    self.fingerprint = compute_fingerprint(self.version, self.dataset,
                                           self.choices)

  # ------------------------------------------------------------- (de)ser

  def to_json(self) -> dict:
    return dict(version=self.version, fingerprint=self.fingerprint,
                dataset=self.dataset, choices=self.choices,
                evidence=self.evidence)

  @classmethod
  def from_json(cls, obj: dict) -> 'TuneArtifact':
    v = obj.get('version')
    if v not in _VERSION_CHOICE_KEYS:
      raise ValueError(f'unsupported tune-artifact version {v!r} '
                       f'(this build reads versions '
                       f'{sorted(_VERSION_CHOICE_KEYS)})')
    stored = obj.get('fingerprint')
    if v < ARTIFACT_VERSION:
      # older-schema artifact: validate against ITS OWN closed knob
      # set and its own-version fingerprint (the file must still be
      # the tuner's, untouched), then upgrade — the keys it predates
      # load as the documented defaults (kernels off for v1, local
      # topology for v1/v2; docs/tuning.md 'Artifact schema'), never
      # as a refusal
      choices = dict(obj['choices'])
      unknown = set(choices) - _VERSION_CHOICE_KEYS[v]
      if unknown:
        raise ValueError(f'unknown choice keys {sorted(unknown)} — the '
                         f'version-{v} artifact knob set is closed '
                         '(docs/tuning.md)')
      if stored is not None:
        expect = compute_fingerprint(v, obj.get('dataset'), choices)
        if stored != expect:
          raise ValueError(
              f'tune-artifact fingerprint mismatch: stored {stored}, '
              f'recomputed {expect} — the file was edited after the '
              'tuner emitted it; re-run tune() instead of hand-patching '
              'a signed artifact (docs/tuning.md)')
      art = cls(choices, obj.get('dataset'), obj.get('evidence'))
      art.evidence.append(dict(
          kind='schema_upgrade', from_version=v,
          to_version=ARTIFACT_VERSION,
          note=('pre-kernel-routing artifact: kernel choices defaulted '
                'to off, topology to local (docs/tuning.md)' if v == 1
                else
                'pre-topology artifact: topology defaulted to local — '
                'the only scenario the v2 tuner scored '
                '(docs/tuning.md)')))
      return art
    art = cls(obj['choices'], obj.get('dataset'),
              obj.get('evidence'))
    if stored is not None and stored != art.fingerprint:
      raise ValueError(
          f'tune-artifact fingerprint mismatch: stored {stored}, '
          f'recomputed {art.fingerprint} — the file was edited after '
          'the tuner emitted it; re-run tune() instead of hand-patching '
          'a signed artifact (docs/tuning.md)')
    return art

  def save(self, path: str) -> str:
    with open(path, 'w') as f:
      json.dump(self.to_json(), f, indent=2, sort_keys=True)
      f.write('\n')
    return path

  @classmethod
  def load(cls, path: str) -> 'TuneArtifact':
    with open(path) as f:
      return cls.from_json(json.load(f))

  # ---------------------------------------------------------- validation

  def validate_dataset(self, dataset, where: str = 'config'):
    """Refuse a dataset that drifted from the one this config was
    tuned for — a tuned cap/cache/chunk assignment on a different
    graph silently loses the evidence behind every choice. Hetero
    datasets validate TYPED (per-etype CSR records, per-ntype books);
    degrades to a warning only when the dataset has no computable
    fingerprint at all (e.g. a remote client holding no graph)."""
    if self.dataset is None:
      return
    fp = dataset_fingerprint(dataset)
    if fp is None:
      import warnings
      warnings.warn(
          f'{where}: dataset has no computable fingerprint — tuned '
          'config accepted unvalidated', RuntimeWarning, stacklevel=3)
      return
    drift = {k: (self.dataset.get(k), fp.get(k))
             for k in set(self.dataset) | set(fp)
             if self.dataset.get(k) != fp.get(k)}
    if drift:
      raise ValueError(
          f'{where}: tuned-config dataset fingerprint mismatch '
          f'{drift} — this artifact was tuned for a different graph '
          '(artifact fingerprint '
          f'{self.fingerprint}); re-run graphlearn_tpu_torch.tune() on the '
          'current dataset (docs/tuning.md)')

  # --------------------------------------------------------- constructor
  # accessors: the kwarg bundles the loader / trainer / serving
  # constructors consume (docs/tuning.md quickstart)

  def loader_kwargs(self) -> dict:
    """NeighborLoader kwargs for the chosen sampling mode. The fused-hop
    keys are not among them: the port's hop kernels route by device."""
    mode = self.choices['mode']
    kw = dict(batch_size=self.choices['batch_size'], dedup=mode)
    if mode in ('map', 'sort', 'merge') and \
        self.choices.get('frontier_caps') is not None:
      # caps clamp the EXACT-dedup buffer plan; the relaxed tree mode
      # sizes its own computation-tree layout
      kw['frontier_caps'] = list(self.choices['frontier_caps'])
    if self.choices.get('padded_window') is not None:
      kw['padded_window'] = self.choices['padded_window']
    return kw

  def kernel_kwargs(self) -> dict:
    """The tuned kernel-routing bundle (KERNEL_CHOICE_KEYS): which
    kernel routes the observatory A/Bs selected. Kernels default
    off — a key absent from an older choices dict reads as off."""
    return {k: self.choices.get(k, KERNEL_CHOICE_DEFAULTS[k])
            for k in KERNEL_CHOICE_KEYS}

  def apply_kernel_routing(self, target) -> bool:
    """Stamp the tuned gather-kernel routing onto ``target``'s feature
    / embedding store (the ``config=`` acceptors call this so kernel
    selection is an artifact choice, not an env var). Returns True
    when at least one store accepted the flags."""
    return apply_kernel_routing(target, self.kernel_kwargs())

  @property
  def topology(self) -> str:
    """Which trainer scenario this artifact was tuned for ('local' /
    'dist' / 'remote' / 'tiered_dist'). The ``config=`` acceptors
    refuse a mismatched non-local topology — a remote block-stream
    assignment says nothing about a tiered exchange (docs/tuning.md
    'Topology candidates')."""
    return self.choices.get('topology') or 'local'

  def topology_kwargs(self) -> dict:
    """The tuned scenario knobs only this artifact's topology consumes
    (TOPOLOGY_CHOICE_KEYS minus the topology tag itself), Nones
    dropped: ``block_ahead``/``block_wire_dtype`` for remote block
    streams, ``hot_prefix_rows`` for the tiered exchange."""
    out = {k: self.choices.get(k)
           for k in TOPOLOGY_CHOICE_KEYS if k != 'topology'}
    return {k: v for k, v in out.items() if v is not None}

  def trainer_kwargs(self) -> dict:
    """Scan-trainer kwargs (chunk K); the trainers also re-validate the
    dataset fingerprint when handed the artifact via ``config=``."""
    return dict(chunk_size=int(self.choices['chunk_k']))

  def serving_kwargs(self) -> dict:
    """ServingEngine kwargs (the calibrated padded-bucket ladder)."""
    return dict(buckets=tuple(self.choices['serving_buckets']))


def apply_kernel_routing(target, kernel: Optional[dict] = None) -> bool:
  """Route the chosen gather kernel into every store hanging off
  ``target`` that understands ``set_kernel_routing`` (data.Feature via
  its UnifiedTensor, serving's EmbeddingStore; on a card
  ``use_pallas_v2`` routes their lookups through the run-segmented
  gather kernel). ``target`` may be a Dataset (its ``node_features``
  are walked, hetero dicts included), a feature store, or an embedding
  store. Keys absent from ``kernel`` fall back to the kernels-off
  defaults, so applying is idempotent AND resets flags a previous
  candidate probe set (tune/tuner.py scores candidates in sequence
  over one dataset)."""
  kw = dict(KERNEL_CHOICE_DEFAULTS)
  kw.update({k: v for k, v in (kernel or {}).items() if v is not None})
  stores = getattr(target, 'node_features', target)
  if not isinstance(stores, dict):
    stores = {None: stores}
  applied = False
  for store in stores.values():
    if hasattr(store, 'set_kernel_routing'):
      store.set_kernel_routing(
          use_pallas_v2=bool(kw['use_pallas_v2']),
          block_rows=int(kw['gather2_block_rows']),
          run_span=int(kw['gather2_run_span']))
      applied = True
  return applied
