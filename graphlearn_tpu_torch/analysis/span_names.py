"""Rule span-registry: span names are literal, registered, and
documented: the span namespace stays closed, like metric names.

Span trees are joined across processes by NAME + id (metrics/spans.py):
the postmortem tooling and the span table all key on exact names, so a
typo'd or ad-hoc span name silently orphans its subtree from every
consumer. This rule is the span instance of the ``metric-registry``
contract and reuses its machinery:

  * span-emitting call sites across the package: ``spans.span`` /
    ``spans.begin`` / ``spans.emit`` (resolved through import aliases;
    the name is the first positional or the ``name`` keyword);
  * the ``REGISTERED_SPANS`` frozenset in ``metrics/registry_names.py``
    (parsed from source, never imported); ``<prefix>.*`` wildcard
    entries are honored for symmetry though the shipped set is fully
    literal;
  * the span table of the port's observability doc: every registry
    entry must appear there in backticks.

The metrics package itself is exempt (it manipulates names as data),
exactly like the metric rule.
"""
import ast
from typing import List, Optional, Set

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope
from .metric_names import (_documented_names, _literal_parts, _name_arg,
                           _parse_registry, _registered)

RULE = 'span-registry'

# last segment checked when the call resolves under a `spans` namespace
# (spans.span(...), metrics.spans.begin(...), or a bare name imported
# from the spans module)
_SPAN_FNS = ('span', 'begin', 'emit')


def _is_span_call(name: Optional[str]) -> Optional[str]:
  if not name:
    return None
  parts = name.split('.')
  if parts[-1] in _SPAN_FNS and len(parts) >= 2 and \
      parts[-2] == 'spans':
    return parts[-1]
  return None


def check_package(modules: List[ParsedModule], config: Config):
  out: List[Finding] = []
  registry_mod = None
  for mod in modules:
    if mod.relpath == config.metrics_registry_module:
      registry_mod = mod
  entries, reg_line = _parse_registry(registry_mod,
                                      name='REGISTERED_SPANS')
  exact: Set[str] = {e for e in entries if not e.endswith('.*')} \
      if entries is not None else set()
  wildcards: Set[str] = {e[:-1] for e in entries if e.endswith('.*')} \
      if entries is not None else set()
  documented = _documented_names(config)

  for mod in modules:
    if in_scope(mod.relpath, config.metrics_exempt_modules):
      continue
    aliases = astutil.aliases_of(mod)
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      fn = _is_span_call(
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
            f'span name passed to spans.{fn}() is not a string literal '
            '— computed names escape the closed namespace '
            '(metrics/registry_names.py REGISTERED_SPANS); use a '
            'literal, or a registered <prefix>.* wildcard f-string'))
        continue
      if entries is None:
        continue   # registry unparseable: its own finding covers it
      if full is not None:
        if not _registered(full, exact, wildcards):
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'span name {full!r} is not in metrics/registry_names.py '
              'REGISTERED_SPANS — register it (and add it to the '
              f'{config.observability_doc} span table) in the same '
              'change'))
        elif documented is not None and full in exact and \
            full not in documented:
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'span name {full!r} is registered but missing from the '
              f'{config.observability_doc} span table — document it '
              '(emitter, tree position, meaning)'))
      else:   # f-string: literal head must contain a full wildcard
        if not head or not any(head.startswith(w) for w in wildcards):
          out.append(Finding(
              RULE, mod.path, mod.relpath, arg.lineno,
              arg.col_offset + 1,
              f'f-string span name with literal head {head!r} matches '
              'no <prefix>.* wildcard in REGISTERED_SPANS — register '
              'the family wildcard, or use a literal name'))

  if entries is None and registry_mod is not None:
    out.append(Finding(
        RULE, registry_mod.path, registry_mod.relpath, 1, 1,
        'metrics/registry_names.py defines no REGISTERED_SPANS '
        'frozenset — the span-name registry is the anchor this rule '
        'checks against'))
  elif entries is not None and documented is not None and registry_mod:
    for name in sorted(set(entries) - documented):
      out.append(Finding(
          RULE, registry_mod.path, registry_mod.relpath, reg_line, 1,
          f'REGISTERED_SPANS entry {name!r} is not documented in '
          f'{config.observability_doc} — add it to the span table'))
  return out
