"""graftlint core: findings, pragmas, baseline, module loading, runner.

Checker modules each expose ``RULE`` (the rule id) and
``check_package(modules, config)`` returning findings over the whole
parsed-module set: package-wide scope is the common case (fault-site
uniqueness spans files), and per-file rules simply loop.

Suppression layers, in order:

  1. pragma: ``# graftlint: allow[<rule>] <reason>`` on the flagged
     line (or on a line of its own directly above it) suppresses that
     rule there. A reason is REQUIRED: an unexplained exception is
     itself a finding (rule ``pragma``), as is an unknown rule name.
  2. baseline: a checked-in JSON of finding fingerprints
     (``graftlint.baseline.json`` in the linted package) for debt
     accepted at introduction. Fingerprints hash (rule, relpath,
     stripped source line, occurrence index), not line numbers, so
     unrelated edits don't churn them. The port's baseline is EMPTY and
     its tests keep it so.

The pragma grammar, the fingerprints and the baseline file format are
the JAX package's (``graphlearn_tpu/analysis/core.py``), so the two
linters compute the same fingerprint for the same line.
"""
import ast
import hashlib
import io
import json
import os
import re
import time
import tokenize
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Finding:
  rule: str
  path: str          # absolute file path
  relpath: str       # package-relative (the scoping + fingerprint key)
  line: int
  col: int
  message: str
  symbol: str = ''   # enclosing function qualname, when known

  def location(self) -> str:
    return f'{self.relpath}:{self.line}'

  def render(self) -> str:
    sym = f' [{self.symbol}]' if self.symbol else ''
    return f'{self.relpath}:{self.line}:{self.col}: {self.rule}: ' \
           f'{self.message}{sym}'


@dataclass
class Config:
  """Scoping knobs. Defaults encode the port's hot-path contracts; tests
  override them to point rules at fixture files.

  Module patterns are package-relative posix paths: a pattern ending in
  '/' is a directory prefix, '*' matches every module, anything else is
  an exact file match. The module lists are the JAX package's where the
  port has the same module.
  """
  # rule host-sync: modules whose captured code must be sync-free
  hot_sync_modules: Tuple[str, ...] = (
      'loader/scan_epoch.py', 'loader/pipeline.py',
      'loader/run_epoch.py',
      'distributed/dist_feature.py', 'distributed/dist_neighbor_sampler.py',
      'distributed/remote_scan.py', 'distributed/block_producer.py',
      'ops/', 'serving/', 'storage/', 'recovery/', 'tune/')
  # rule host-sync: functions that run inside a captured step wherever a
  # hot module defines them, beyond what the capture roots reach inside
  # one module (the chunk bodies call across modules)
  traced_step_functions: Tuple[str, ...] = ('_chunk',)
  # rule dispatch-instrumentation: modules whose graph replays must
  # record dispatches (the dispatch-budget tests' instrumented surface)
  dispatch_modules: Tuple[str, ...] = (
      'loader/scan_epoch.py', 'loader/pipeline.py', 'loader/node_loader.py',
      'distributed/dist_feature.py', 'distributed/dist_neighbor_sampler.py',
      'distributed/dist_loader.py', 'distributed/remote_scan.py',
      'distributed/block_producer.py', 'sampler/neighbor_sampler.py',
      'data/unified_tensor.py', 'serving/', 'storage/', 'recovery/',
      'ops/sample_fused.py', 'loader/run_epoch.py', 'tune/')
  # rule prng-discipline: sampler/loader surfaces with replay contracts
  prng_modules: Tuple[str, ...] = ('sampler/', 'loader/', 'distributed/')
  # rule fault-point-coverage inputs (package-relative / repo-relative)
  fault_registry_module: str = 'utils/faults.py'
  failure_doc: str = 'graphlearn_tpu_torch/docs/failure_model.md'
  # rule metric-registry inputs: the closed metric-name frozenset, its
  # documentation table, and the modules exempt from call-site checks
  # (the metrics package itself registers/loops over names as data)
  metrics_registry_module: str = 'metrics/registry_names.py'
  observability_doc: str = 'graphlearn_tpu_torch/docs/observability.md'
  metrics_exempt_modules: Tuple[str, ...] = ('metrics/',)
  # flow-aware rules (bracket-discipline / lock-discipline): scoped
  # package-wide, since they key on idioms (bracket openers, shared[]
  # annotations) rather than on module lists
  bracket_modules: Tuple[str, ...] = ('*',)
  lock_modules: Tuple[str, ...] = ('*',)
  # resolved at run time from the linted paths unless set explicitly
  repo_root: Optional[str] = None


@dataclass
class ParsedModule:
  path: str
  relpath: str
  source: str
  lines: List[str]
  tree: ast.AST
  # line -> set of rule names a pragma allows there (after same-line +
  # line-above expansion)
  pragmas: Dict[int, set] = field(default_factory=dict)
  pragma_findings: List[Finding] = field(default_factory=list)
  # line -> [(kind, arg)] for the non-allow annotation forms the lock
  # rule consumes: '# graftlint: shared[<lock>]' on a field's defining
  # assignment, '# graftlint: locked[<lock>]' on a def
  annotations: Dict[int, list] = field(default_factory=dict)
  # per-module AST products every rule shares (function index, import
  # aliases, parent map), built once by astutil's *_of helpers
  cache: Dict[str, object] = field(default_factory=dict, repr=False)


def in_scope(relpath: str, patterns: Sequence[str]) -> bool:
  for p in patterns:
    if p == '*':
      return True
    if p.endswith('/') and relpath.startswith(p):
      return True
    if relpath == p:
      return True
  return False


# ------------------------------------------------------------------ pragmas

PRAGMA_RULES = ('host-sync', 'prng-discipline', 'dispatch-instrumentation',
                'fault-point-coverage', 'metric-registry', 'span-registry',
                'hetero-gate', 'bracket-discipline', 'lock-discipline')
_PRAGMA_MARK = 'graftlint:'
_PRAGMA_RX = re.compile(r'#\s*graftlint:\s*(allow|shared|locked)'
                        r'\[([^\]]*)\]\s*(.*)$')


def _pragma_comments(mod: ParsedModule):
  """(lineno, comment_text, own_line) for comment TOKENS mentioning
  graftlint. Tokenizing (not line-scanning) keeps pragma lookalikes in
  docstrings, like the ones documenting the pragma itself, inert."""
  try:
    tokens = tokenize.generate_tokens(io.StringIO(mod.source).readline)
    for tok in tokens:
      if tok.type == tokenize.COMMENT and _PRAGMA_MARK in tok.string:
        own_line = mod.lines[tok.start[0] - 1].strip().startswith('#')
        yield tok.start[0], tok.string, own_line
  except tokenize.TokenError:
    return


def _parse_pragmas(mod: ParsedModule):
  """Collect allow-pragmas and shared[]/locked[] annotations per line;
  malformed ones become findings."""
  for i, text, own_line in _pragma_comments(mod):
    m = _PRAGMA_RX.search(text)
    if not m:
      mod.pragma_findings.append(Finding(
          'pragma', mod.path, mod.relpath, i, 1,
          "malformed graftlint pragma — expected '# graftlint: "
          "allow[<rule>] <reason>', '# graftlint: shared[<lock>]' or "
          "'# graftlint: locked[<lock>]'"))
      continue
    kind = m.group(1)
    targets = [i]
    # a pragma on a comment-only line covers the next line
    if own_line:
      targets.append(i + 1)
    if kind in ('shared', 'locked'):
      arg = m.group(2).strip()
      if not arg or ',' in arg:
        mod.pragma_findings.append(Finding(
            'pragma', mod.path, mod.relpath, i, 1,
            f'graftlint {kind}[...] annotation needs exactly one lock '
            'name inside the brackets'))
        continue
      for t in targets:
        mod.annotations.setdefault(t, []).append((kind, arg))
      continue
    rules = {r.strip() for r in m.group(2).split(',') if r.strip()}
    reason = m.group(3).strip()
    bad = rules - set(PRAGMA_RULES)
    if bad or not rules:
      mod.pragma_findings.append(Finding(
          'pragma', mod.path, mod.relpath, i, 1,
          f'unknown rule(s) in pragma: {sorted(bad) or "(none)"} — '
          f'valid rules: {", ".join(PRAGMA_RULES)}'))
      continue
    if not reason:
      mod.pragma_findings.append(Finding(
          'pragma', mod.path, mod.relpath, i, 1,
          'graftlint pragma needs a reason after the closing bracket '
          '(unexplained exceptions rot)'))
      continue
    for t in targets:
      mod.pragmas.setdefault(t, set()).update(rules)


def suppressed(mod: ParsedModule, finding: Finding) -> bool:
  return finding.rule in mod.pragmas.get(finding.line, ())


# ----------------------------------------------------------------- baseline

BASELINE_NAME = 'graftlint.baseline.json'


def fingerprint(f: Finding, lines: List[str], occurrence: int) -> str:
  text = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ''
  h = hashlib.sha1(
      f'{f.rule}|{f.relpath}|{text}|{occurrence}'.encode()).hexdigest()
  return h[:16]


def fingerprints_for(findings: List[Finding],
                     modules: Dict[str, ParsedModule]) -> List[str]:
  """Stable fingerprints: occurrence index disambiguates identical
  (rule, file, line-text) triples so two equal violations don't share
  one baseline slot."""
  seen: Dict[Tuple[str, str, str], int] = {}
  out = []
  for f in findings:
    mod = modules.get(f.path)
    lines = mod.lines if mod else []
    text = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ''
    key = (f.rule, f.relpath, text)
    occ = seen.get(key, 0)
    seen[key] = occ + 1
    out.append(fingerprint(f, lines, occ))
  return out


def load_baseline(path: str) -> set:
  if not os.path.exists(path):
    return set()
  with open(path) as fh:
    data = json.load(fh)
  if not isinstance(data, dict) or data.get('version') != 1:
    raise ValueError(f'{path}: not a graftlint baseline (version 1)')
  return set(data.get('fingerprints', []))


def write_baseline(path: str, findings: List[Finding],
                   modules: Dict[str, ParsedModule]):
  data = {'version': 1,
          'fingerprints': sorted(fingerprints_for(findings, modules))}
  with open(path, 'w') as fh:
    json.dump(data, fh, indent=2, sort_keys=True)
    fh.write('\n')


# ------------------------------------------------------------ module loading

def package_top(path: str) -> Optional[str]:
  """The topmost directory of the package chain holding ``path`` (each
  level carries ``__init__.py``), or None outside a package."""
  d = os.path.abspath(path)
  if not os.path.isdir(d):
    d = os.path.dirname(d)
  top = None
  while os.path.exists(os.path.join(d, '__init__.py')):
    top = d
    parent = os.path.dirname(d)
    if parent == d:
      break
    d = parent
  return top


def _package_relpath(path: str) -> str:
  """Path relative to the file's topmost enclosing package. Fixture
  files in bare temp dirs fall back to their basename, which tests
  match with exact-name patterns."""
  path = os.path.abspath(path)
  top = package_top(path)
  if top is None:
    return os.path.basename(path)
  rel = os.path.relpath(path, os.path.dirname(top)).replace(os.sep, '/')
  return rel.split('/', 1)[-1]


def parse_module(path: str) -> Optional[ParsedModule]:
  with open(path, encoding='utf-8') as fh:
    source = fh.read()
  try:
    tree = ast.parse(source, filename=path)
  except SyntaxError as e:
    mod = ParsedModule(path, _package_relpath(path), source,
                       source.splitlines(), ast.Module(body=[],
                                                       type_ignores=[]))
    mod.pragma_findings.append(Finding(
        'syntax', mod.path, mod.relpath, e.lineno or 1, e.offset or 1,
        f'file does not parse: {e.msg}'))
    return mod
  mod = ParsedModule(path, _package_relpath(path), source,
                     source.splitlines(), tree)
  _parse_pragmas(mod)
  return mod


def collect_files(paths: Sequence[str]) -> List[str]:
  out = []
  for p in paths:
    p = os.path.abspath(p)
    if os.path.isdir(p):
      for dirpath, dirnames, filenames in os.walk(p):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ('__pycache__', '.git', 'build'))
        for fn in sorted(filenames):
          if fn.endswith('.py'):
            out.append(os.path.join(dirpath, fn))
    elif p.endswith('.py'):
      out.append(p)
  return out


# ------------------------------------------------------------------- runner

def _checkers():
  from . import (brackets, dispatch, fault_points, hetero_gates, host_sync,
                 locks, metric_names, prng, span_names)
  return (host_sync, prng, dispatch, fault_points, metric_names,
          span_names, hetero_gates, brackets, locks)


@dataclass
class LintResult:
  """``run_lint``'s result. Unpacks as the 4-tuple ``(findings,
  n_pragma, n_base, modules)``; ``timings`` adds per-rule wall seconds
  for the CLI summary / JSON output."""
  findings: List[Finding]
  n_pragma: int
  n_base: int
  modules: Dict[str, ParsedModule]
  timings: Dict[str, float] = field(default_factory=dict)

  def __iter__(self):
    return iter((self.findings, self.n_pragma, self.n_base, self.modules))


def run_lint(paths: Sequence[str], config: Optional[Config] = None,
             baseline: Optional[set] = None) -> LintResult:
  """Lint ``paths`` (files/dirs). Returns a :class:`LintResult` (which
  unpacks as ``(findings, suppressed_count, baselined_count, modules)``)
  where ``findings`` are the live (neither pragma- nor baseline-
  suppressed) findings, sorted by location."""
  config = config or Config()
  files = collect_files(paths)
  modules: Dict[str, ParsedModule] = {}
  for f in files:
    mod = parse_module(f)
    if mod is not None:
      modules[mod.path] = mod
  if config.repo_root is None and files:
    # the directory holding the topmost package: doc paths resolve here
    top = package_top(files[0])
    config = replace(config, repo_root=os.path.dirname(top) if top
                     else os.path.dirname(files[0]))

  mods = list(modules.values())
  raw: List[Finding] = []
  for mod in mods:
    raw.extend(mod.pragma_findings)
  timings: Dict[str, float] = {}
  for checker in _checkers():
    t0 = time.monotonic()
    raw.extend(checker.check_package(mods, config))
    rule = getattr(checker, 'RULE', checker.__name__)
    timings[rule] = timings.get(rule, 0.0) + (time.monotonic() - t0)

  live, n_pragma = [], 0
  for f in raw:
    mod = modules.get(f.path)
    if mod is not None and suppressed(mod, f):
      n_pragma += 1
    else:
      live.append(f)

  n_base = 0
  if baseline:
    fps = fingerprints_for(live, modules)
    kept = []
    for f, fp in zip(live, fps):
      if fp in baseline:
        n_base += 1
      else:
        kept.append(f)
    live = kept

  live.sort(key=lambda f: (f.relpath, f.line, f.col, f.rule))
  return LintResult(live, n_pragma, n_base, modules, timings)
