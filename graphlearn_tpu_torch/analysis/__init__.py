"""graftlint for the port: AST-level static analysis of
``graphlearn_tpu_torch``'s hot-path invariants.

The port's own copy of the JAX package's analyzer. The hot-path rules
are held at run time mostly by card tests; this package checks them by
AST alone, anywhere Python runs: zero implicit host syncs inside
captured step bodies, counter-addressed (never split-and-carry) keys so
chunk replay stays bit-identical, a recorded dispatch at every graph
replay so the dispatch budgets mean anything, brackets (spans, flight
records, fault arms) closed on every path, shared fields kept under
their lock, and closed registries of fault-site, metric and span names.
Line-level ``# graftlint: allow[<rule>] <reason>`` pragmas and a
checked-in baseline (``graphlearn_tpu_torch/graftlint.baseline.json``,
empty) hold the intentional exceptions.

CLI::

    python -m graphlearn_tpu_torch.analysis.lint graphlearn_tpu_torch/

Rules:

    host-sync                 host round-trips inside captured code
    prng-discipline           split-and-carry / key reuse in samplers
    dispatch-instrumentation  unrecorded CUDA graph replays
    fault-point-coverage      unregistered / undocumented fault sites
    metric-registry           unregistered / undocumented metric names
    span-registry             unregistered / undocumented span names
    hetero-gate               typed refusals outside CapacityPlanError
    bracket-discipline        brackets left open on some path
    lock-discipline           shared fields outside their lock; cycles

The shared rules (fault points, metric and span names, hetero gates,
brackets, locks, pragmas, baseline) and the CFG (``flow.py``) are
JAX's, held equal to JAX's in ``tests/test_torch_analysis.py`` and
``tests/test_torch_flow_rules.py``. The host-sync, PRNG and dispatch
rules are torch rules: JAX's key on ``jax.jit``, ``lax.scan`` and
``jax.random`` and say nothing over torch code.

JAX-only rules, with no counterpart here:

    compat-shard-map   the port has no ``utils/compat.py`` and no
                       ``shard_map``: its mesh is ``torch.distributed``
                       (or a one-process view), not a jax transform
    donation-safety    torch does not donate buffers: no argument is
                       dead after a call, so no read after one is stale
    retrace-hazard     a torch call has no static arguments to retrace
                       on; a shape change in the port costs a CUDA
                       graph recapture, which
                       ``metrics/programs.retrace_budget`` counts at
                       run time

This package imports neither torch nor jax nor the rest of either
package: everything is pure ``ast`` over source text.
"""
from .core import Config, Finding, load_baseline, run_lint, write_baseline

__all__ = ['Config', 'Finding', 'run_lint', 'load_baseline',
           'write_baseline']
