"""graftlint CLI for the port.

Usage::

    python -m graphlearn_tpu_torch.analysis.lint graphlearn_tpu_torch/
    python -m graphlearn_tpu_torch.analysis.lint --format json graphlearn_tpu_torch/
    python -m graphlearn_tpu_torch.analysis.lint --changed-only graphlearn_tpu_torch/
    python -m graphlearn_tpu_torch.analysis.lint --profile bench graphlearn_tpu_torch/benchmarks/
    python -m graphlearn_tpu_torch.analysis.lint --write-baseline graphlearn_tpu_torch/
    python -m graphlearn_tpu_torch.analysis.lint --list-rules

Exit codes: 0 clean (after pragmas + baseline), 1 findings, 2 usage /
internal error. The default baseline is ``graftlint.baseline.json`` at
the top of the linted package (``graphlearn_tpu_torch/graftlint.
baseline.json``, kept EMPTY), or in the linted directory outside a
package; never the directory above, which holds the JAX package's own
baseline. ``--write-baseline`` writes there too, or to ``--baseline``.

``--changed-only`` still parses and analyses every given path (the
cross-module rules, registries and lock-order cycles, need whole-tree
context to be sound) and then REPORTS only findings in files touched vs
``--base-ref`` (default HEAD, plus staged/unstaged/untracked). Use it
in pre-commit hooks to see only your own debt without weakening the
analysis.

``--profile bench`` is the relaxed profile for the port's
``benchmarks/``: the registry rules (metric/span/fault-point names) and
bracket discipline stay enforced (a benchmark that leaks spans measures
garbage) while the hot-path scoping rules (host-sync, dispatch
instrumentation, prng discipline, lock discipline) are exempt:
benchmarks sync on purpose and replay directly.
"""
import argparse
import json
import os
import subprocess
import sys

from .core import (BASELINE_NAME, PRAGMA_RULES, Config, load_baseline,
                   package_top, run_lint, write_baseline)

_RULE_DOCS = {
    'host-sync':
        'device->host sync calls (.item/.tolist/.cpu/.numpy/.to(cpu)/'
        'int()/float()/bool()/np.asarray/synchronize) and allocations '
        'sized by the data (nonzero/unique/masked_select/'
        'repeat_interleave without output_size) reachable from captured '
        'step bodies in hot modules, outside strict.explicit()',
    'prng-discipline':
        'split-and-carry keys, constant keys (PRNGKey, a seeded '
        'torch.Generator) in loops, and key reuse over the port\'s '
        'random module in sampler/loader modules: the fold_in counter '
        'pattern is the contract chunk replay depends on',
    'dispatch-instrumentation':
        'captured CUDA graph replays (torch.cuda.CUDAGraph / '
        'capture_chunk handles) without record_dispatch/wrap_dispatch '
        'in hot modules, through locals, self attributes and containers',
    'fault-point-coverage':
        'fault_point sites must be literal, unique, in '
        'utils/faults.py REGISTERED_SITES, and documented in '
        'graphlearn_tpu_torch/docs/failure_model.md',
    'metric-registry':
        'metric names (counter_inc / metrics.inc/observe/set_gauge/'
        'counter/gauge/histogram) must be string literals registered '
        'in metrics/registry_names.py REGISTERED_METRICS and '
        'documented in graphlearn_tpu_torch/docs/observability.md',
    'span-registry':
        'span names (spans.span/begin/emit) must be string literals '
        'registered in metrics/registry_names.py REGISTERED_SPANS and '
        'documented in the graphlearn_tpu_torch/docs/observability.md '
        'span table',
    'hetero-gate':
        'is_hetero-gated raise/warn outside sampler/capacity.py must '
        'raise CapacityPlanError (the typed refusal naming the missing '
        'plan input, docs/capacity_plans.md) or carry an allow pragma '
        'for a real semantic boundary',
    'bracket-discipline':
        'spans.begin / flight.epoch_begin / faults.arm tokens must '
        'provably close on EVERY outgoing path (exception edges '
        'included); strict_guards / strict.explicit / spans.span only '
        'in a with; fix with try/finally or the with-form',
    'lock-discipline':
        "fields annotated '# graftlint: shared[<lock>]' accessed "
        "outside a with-block holding the lock (or a '# graftlint: "
        "locked[<lock>]' method), plus cross-module lock-order cycle "
        'detection over with-nesting and call edges',
}


def _baseline_home(path: str) -> str:
  """Where a linted path's baseline lives: the top of its package, or
  the directory itself outside one."""
  p = os.path.abspath(path)
  d = p if os.path.isdir(p) else os.path.dirname(p)
  return package_top(d) or d


def _default_baseline(paths):
  for p in paths:
    cand = os.path.join(_baseline_home(p), BASELINE_NAME)
    if os.path.exists(cand):
      return cand
  return None


def _profile_config(profile: str) -> Config:
  if profile == 'bench':
    # see the module docstring: registries + brackets stay on, the
    # hot-path scoping rules are exempt for benchmark code
    return Config(hot_sync_modules=(), dispatch_modules=(),
                  prng_modules=(), lock_modules=())
  return Config()


def _changed_files(paths, base_ref: str):
  """Absolute paths of files changed vs ``base_ref`` (diff against the
  ref + staged + unstaged + untracked), or None when git is unusable —
  the caller then reports everything rather than hiding findings."""
  anchor = os.path.abspath(paths[0])
  cwd = anchor if os.path.isdir(anchor) else os.path.dirname(anchor)
  changed = set()
  cmds = [['git', 'diff', '--name-only', base_ref],
          ['git', 'ls-files', '--others', '--exclude-standard']]
  try:
    top = subprocess.run(['git', 'rev-parse', '--show-toplevel'],
                         cwd=cwd, capture_output=True, text=True,
                         timeout=30)
    if top.returncode != 0:
      return None
    root = top.stdout.strip()
    for cmd in cmds:
      r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=60)
      if r.returncode != 0:
        return None
      changed.update(os.path.abspath(os.path.join(root, line))
                     for line in r.stdout.splitlines() if line)
  except (OSError, subprocess.SubprocessError):
    return None
  return changed


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(
      prog='python -m graphlearn_tpu_torch.analysis.lint',
      description='graftlint: hot-path invariant checks for '
                  'graphlearn_tpu_torch (see the package README section '
                  '"Static analysis")')
  ap.add_argument('paths', nargs='*', help='files or directories to lint')
  ap.add_argument('--baseline', default=None,
                  help='baseline JSON (default: graftlint.baseline.json '
                       'at the top of the linted package, when present)')
  ap.add_argument('--no-baseline', action='store_true',
                  help='ignore any baseline file')
  ap.add_argument('--write-baseline', action='store_true',
                  help='accept current findings into the baseline file')
  ap.add_argument('--list-rules', action='store_true')
  ap.add_argument('--format', choices=('text', 'json'), default='text',
                  help='output format; json includes per-rule timings')
  ap.add_argument('--timings', action='store_true',
                  help='print per-rule wall time after the summary')
  ap.add_argument('--changed-only', action='store_true',
                  help='analyse everything, report only findings in '
                       'files changed vs --base-ref (+ staged/untracked)')
  ap.add_argument('--base-ref', default='HEAD',
                  help='git ref --changed-only diffs against '
                       '(default: HEAD)')
  ap.add_argument('--profile', choices=('default', 'bench'),
                  default='default',
                  help="'bench': relaxed scoping for the port's "
                       'benchmarks/ (registries/brackets still enforced)')
  ap.add_argument('-q', '--quiet', action='store_true',
                  help='summary line only')
  args = ap.parse_args(argv)

  if args.list_rules:
    for rule in PRAGMA_RULES:
      print(f'{rule}\n    {_RULE_DOCS[rule]}')
    return 0
  if not args.paths:
    ap.print_usage(sys.stderr)
    print('error: no paths given (try: graphlearn_tpu_torch/)',
          file=sys.stderr)
    return 2

  baseline_path = args.baseline or _default_baseline(args.paths)
  baseline = set()
  if baseline_path and not args.no_baseline and not args.write_baseline:
    try:
      baseline = load_baseline(baseline_path)
    except (ValueError, OSError) as e:
      print(f'error: {e}', file=sys.stderr)
      return 2

  result = run_lint(args.paths, _profile_config(args.profile), baseline)
  findings, n_pragma, n_base, modules = result

  if args.write_baseline:
    path = args.baseline or os.path.join(_baseline_home(args.paths[0]),
                                         BASELINE_NAME)
    write_baseline(path, findings, modules)
    print(f'wrote {len(findings)} fingerprint(s) to {path}')
    return 0

  n_analysed = len(findings)
  if args.changed_only:
    changed = _changed_files(args.paths, args.base_ref)
    if changed is None:
      print('graftlint: --changed-only: git unavailable, reporting all '
            'findings', file=sys.stderr)
    else:
      findings = [f for f in findings
                  if os.path.abspath(f.path) in changed]

  nfiles = len(modules)
  if args.format == 'json':
    doc = {
        'findings': [{'rule': f.rule, 'path': f.path,
                      'relpath': f.relpath, 'line': f.line, 'col': f.col,
                      'message': f.message, 'symbol': f.symbol}
                     for f in findings],
        'files': nfiles,
        'pragma_suppressed': n_pragma,
        'baselined': n_base,
        'changed_only': bool(args.changed_only),
        'analysed_findings': n_analysed,
        'profile': args.profile,
        'timings_ms': {rule: round(dt * 1e3, 2)
                       for rule, dt in sorted(result.timings.items())},
    }
    print(json.dumps(doc, indent=2, sort_keys=True))
    return 1 if findings else 0

  if not args.quiet:
    for f in findings:
      print(f.render())
  extras = []
  if n_pragma:
    extras.append(f'{n_pragma} pragma-suppressed')
  if n_base:
    extras.append(f'{n_base} baselined')
  if args.changed_only and n_analysed != len(findings):
    extras.append(f'{n_analysed - len(findings)} outside --changed-only')
  extra = f' ({", ".join(extras)})' if extras else ''
  print(f'graftlint: {len(findings)} finding(s) in {nfiles} file(s)'
        f'{extra}')
  if args.timings:
    total = sum(result.timings.values())
    for rule, dt in sorted(result.timings.items(),
                           key=lambda kv: -kv[1]):
      print(f'  {rule:28s} {dt * 1e3:9.1f} ms')
    print(f'  {"total (rules)":28s} {total * 1e3:9.1f} ms')
  return 1 if findings else 0


if __name__ == '__main__':
  sys.exit(main())
