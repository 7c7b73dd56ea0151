"""One-call autotuned fast-path configuration.

Counterpart of ``graphlearn_tpu/tune/``. ``tune(dataset, loader_cfg)``
runs the calibration probes and short observatory-scored candidate A/Bs
on the dataset's device and emits a versioned, sha1-fingerprinted
:class:`TuneArtifact` that the chunked trainers and the serving engine
accept directly via ``config=``; a config that would capture in its
steady epoch is rejected by construction. The artifact's JSON is JAX's:
a file either package writes loads in the other.
"""
from .artifact import (ARTIFACT_VERSION, KERNEL_CHOICE_DEFAULTS,
                       KERNEL_CHOICE_KEYS, TOPOLOGY_CHOICE_DEFAULTS,
                       TOPOLOGY_CHOICE_KEYS, TuneArtifact,
                       apply_kernel_routing, dataset_fingerprint)
from .retune import (RetuneScheduler, hit_rate_decay_probe,
                     p99_creep_probe, retrace_overrun_probe)
from .topology import (TOPOLOGY_KNOBS, TOPOLOGY_SITES,
                       TopologyCandidate, default_topology_candidates,
                       screen_candidate, tune_topology)
from .tuner import (Candidate, default_candidates, kernel_candidates,
                    retrace_probe_candidate, score_candidate, tune)

__all__ = [
    'ARTIFACT_VERSION', 'KERNEL_CHOICE_DEFAULTS', 'KERNEL_CHOICE_KEYS',
    'TOPOLOGY_CHOICE_DEFAULTS', 'TOPOLOGY_CHOICE_KEYS',
    'TuneArtifact', 'apply_kernel_routing', 'dataset_fingerprint',
    'RetuneScheduler', 'hit_rate_decay_probe', 'p99_creep_probe',
    'retrace_overrun_probe',
    'TOPOLOGY_KNOBS', 'TOPOLOGY_SITES', 'TopologyCandidate',
    'default_topology_candidates', 'screen_candidate', 'tune_topology',
    'Candidate', 'default_candidates', 'kernel_candidates',
    'retrace_probe_candidate', 'score_candidate', 'tune',
]

# `graphlearn_tpu_torch.tune(dataset, loader_cfg)` IS the one call, as
# `graphlearn_tpu.tune(...)` is — make the subpackage itself callable so
# the package attribute serves both as the namespace
# (tune.TuneArtifact) and as the entry point. Module-class override is
# the supported mechanism (the module object's type gains __call__);
# nothing else about import semantics changes.
import sys as _sys


class _CallableTuneModule(type(_sys.modules[__name__])):

  def __call__(self, dataset, loader_cfg, **kwargs):
    return tune(dataset, loader_cfg, **kwargs)


_sys.modules[__name__].__class__ = _CallableTuneModule
