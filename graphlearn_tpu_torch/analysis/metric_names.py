"""Rule metric-registry: metric names are literal, registered, and
documented, so the exported namespace stays closed.

The metrics layer's value is the CLOSED ``<subsystem>.<event>``
namespace: dashboards, scrapes and the flight-record tooling all key on
exact names, so a typo'd or ad-hoc name silently orphans its series.
This rule cross-checks three sources, mirroring the fault-point-coverage
rule:

  * metric-emitting call sites across the package: the trace shim
    (``counter_inc``) and the idiomatic ``metrics.<fn>`` forms
    (``inc`` / ``observe`` / ``set_gauge`` / ``counter`` / ``gauge`` /
    ``histogram``), resolved through import aliases;
  * the ``REGISTERED_METRICS`` frozenset in
    ``metrics/registry_names.py`` (parsed from source: the linter never
    imports the package). Entries ending ``.*`` are WILDCARDS covering
    runtime-minted tails (``fault.*``); an f-string name whose literal
    head falls under a wildcard passes, any other non-literal name is a
    finding (suppress with a pragma when a dynamic name is genuinely
    required, as publish_stats' prefix parameter is);
  * the naming table of the port's observability doc
    (``Config.observability_doc``): every registry entry must appear
    there in backticks.

No stale-entry check: wildcard families and prefix-parameterized
emitters mint names at runtime, so absence of a literal call site is
not evidence a name is dead.
"""
import ast
import os
from typing import List, Optional, Set, Tuple

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'metric-registry'

# last segments checked when the call resolves under a `metrics`
# namespace (metrics.inc(...), glt.metrics.observe(...), or a bare
# name imported from the metrics package)
_METRIC_FNS = ('inc', 'observe', 'set_gauge', 'counter', 'gauge',
               'histogram')
# distinctive names checked regardless of namespace (the trace shim)
_ALWAYS_FNS = ('counter_inc',)


def _is_metric_call(name: Optional[str]) -> Optional[str]:
  """The checked function's last segment, or None when this call is
  not a metric-emitting form."""
  if not name:
    return None
  parts = name.split('.')
  if parts[-1] in _ALWAYS_FNS:
    return parts[-1]
  if parts[-1] in _METRIC_FNS and len(parts) >= 2 and \
      parts[-2] == 'metrics':
    return parts[-1]
  return None


def _name_arg(call: ast.Call) -> Optional[ast.AST]:
  if call.args:
    return call.args[0]
  for kw in call.keywords:
    if kw.arg == 'name':
      return kw.value
  return None


def _literal_parts(node: ast.AST) -> Tuple[Optional[str], Optional[str]]:
  """(full_literal, literal_head): the whole name when it is a string
  constant, else the leading literal run of an f-string (empty-string
  head when the f-string starts with a substitution), else (None,
  None) for anything non-string."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return node.value, None
  if isinstance(node, ast.JoinedStr):
    head = ''
    for v in node.values:
      if isinstance(v, ast.Constant) and isinstance(v.value, str):
        head += v.value
      else:
        break
    return None, head
  return None, None


def _registered(name: str, exact: Set[str], wildcards: Set[str]) -> bool:
  if name in exact:
    return True
  return any(name.startswith(w) for w in wildcards)


def check_package(modules: List[ParsedModule], config: Config):
  out: List[Finding] = []
  registry_mod = None
  for mod in modules:
    if mod.relpath == config.metrics_registry_module:
      registry_mod = mod
  entries, reg_line = _parse_registry(registry_mod)
  exact = {e for e in entries if not e.endswith('.*')} \
      if entries is not None else set()
  wildcards = {e[:-1] for e in entries if e.endswith('.*')} \
      if entries is not None else set()
  documented = _documented_names(config)

  for mod in modules:
    if in_scope(mod.relpath, config.metrics_exempt_modules):
      continue
    aliases = astutil.aliases_of(mod)
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      fn = _is_metric_call(
          astutil.canonical(astutil.call_name(node), aliases))
      if fn is None:
        continue
      arg = _name_arg(node)
      if arg is None:
        continue
      full, head = _literal_parts(arg)
      if full is None and head is None:
        out.append(Finding(
            RULE, mod.path, mod.relpath, arg.lineno, arg.col_offset + 1,
            f'metric name passed to {fn}() is not a string literal — '
            'computed names escape the closed namespace '
            '(metrics/registry_names.py); use a literal, or a '
            'registered <prefix>.* wildcard f-string'))
        continue
      if entries is None:
        continue   # registry unparseable: its own finding covers it
      if full is not None:
        if not _registered(full, exact, wildcards):
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'metric name {full!r} is not in metrics/'
              'registry_names.py REGISTERED_METRICS — register it '
              f'(and add it to the {config.observability_doc} naming '
              'table) in the same change'))
        elif documented is not None and full in exact and \
            full not in documented:
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'metric name {full!r} is registered but missing from '
              f'the {config.observability_doc} naming table — '
              'document it (kind, unit, meaning)'))
      else:   # f-string: its literal head must fall under a wildcard
        # an empty head (name starts with a substitution) is fully
        # computed — never wildcard-safe. The head must CONTAIN a full
        # wildcard prefix (head.startswith(w)): only then is every
        # runtime completion guaranteed inside the family. The reverse
        # test (w.startswith(head)) would wave through f'd{x}' because
        # 'dist_feature.' happens to start with 'd'.
        if not head or not any(head.startswith(w) for w in wildcards):
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'f-string metric name with literal head {head!r} '
              'matches no <prefix>.* wildcard in REGISTERED_METRICS — '
              'register the family wildcard, or use a literal name'))

  if entries is None and registry_mod is not None:
    out.append(Finding(
        RULE, registry_mod.path, registry_mod.relpath, 1, 1,
        'metrics/registry_names.py defines no REGISTERED_METRICS '
        'frozenset — the metric-name registry is the anchor this rule '
        'checks against'))
  elif entries is not None and documented is not None and registry_mod:
    for name in sorted(set(entries) - documented):
      out.append(Finding(
          RULE, registry_mod.path, registry_mod.relpath, reg_line, 1,
          f'REGISTERED_METRICS entry {name!r} is not documented in '
          f'{config.observability_doc} — add it to the naming table '
          '(wildcards appear literally, e.g. `fault.*`)'))
  return out


def _parse_registry(mod: Optional[ParsedModule],
                    name: str = 'REGISTERED_METRICS'):
  """(entries, lineno) from ``<name> = frozenset({...})``, or
  (None, 0) when unavailable. Shared with the span-registry rule
  (``name='REGISTERED_SPANS'``) — same file, same parse."""
  if mod is None:
    return None, 0
  for node in ast.walk(mod.tree):
    if not isinstance(node, ast.Assign):
      continue
    names = [t.id for t in node.targets if isinstance(t, ast.Name)]
    if name not in names:
      continue
    try:
      value = ast.literal_eval(node.value)
    except ValueError:
      if isinstance(node.value, ast.Call) and node.value.args:
        try:
          value = ast.literal_eval(node.value.args[0])
        except ValueError:
          return None, 0
      else:
        return None, 0
    return set(value), node.lineno
  return None, 0


def _documented_names(config: Config) -> Optional[Set[str]]:
  if not config.repo_root:
    return None
  path = os.path.join(config.repo_root, config.observability_doc)
  if not os.path.exists(path):
    return None
  import re
  with open(path, encoding='utf-8') as fh:
    text = fh.read()
  # backticked tokens, '*' allowed so wildcard entries document as-is
  return set(re.findall(r'`([a-z0-9_.*]+)`', text))
