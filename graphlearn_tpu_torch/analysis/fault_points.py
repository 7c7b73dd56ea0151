"""Rule fault-point-coverage: fault sites are literal, unique,
registered, and documented.

The chaos tests' guarantees are only as good as the fault-site
inventory: a ``fault_point`` whose name is computed at runtime can't be
armed deliberately, a duplicated name arms two sites at once (a chaos
test then *thinks* it killed one code path), an unregistered name is
invisible to the failure-model review, and an undocumented one rots out
of the operator-facing table. This rule cross-checks three sources:

  * ``fault_point('<name>')`` call sites across the package,
  * the ``REGISTERED_SITES`` frozenset in ``utils/faults.py``
    (parsed from source: the linter never imports the package),
  * the fault-site table of the port's failure model
    (``Config.failure_doc``; a name counts as documented when it
    appears in backticks).
"""
import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Config, Finding, ParsedModule

RULE = 'fault-point-coverage'


def check_package(modules: List[ParsedModule], config: Config):
  out: List[Finding] = []
  registry_mod = None
  sites: Dict[str, List[Tuple[ParsedModule, ast.Call]]] = {}

  for mod in modules:
    if mod.relpath == config.fault_registry_module:
      registry_mod = mod
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.Call):
        continue
      seg = astutil.last_segment(astutil.call_name(node))
      if seg != 'fault_point':
        continue
      if not node.args or not isinstance(node.args[0], ast.Constant) \
          or not isinstance(node.args[0].value, str):
        out.append(Finding(
            RULE, mod.path, mod.relpath, node.lineno,
            node.col_offset + 1,
            'fault_point name must be a string literal — a computed '
            'name cannot be armed deliberately from GLT_FAULTS or '
            f'reviewed against {config.failure_doc}'))
        continue
      sites.setdefault(node.args[0].value, []).append((mod, node))

  if not sites:
    return out

  registered, reg_line, reg_mod = _parse_registry(registry_mod)
  documented = _documented_names(config)

  for name, occ in sorted(sites.items()):
    if len(occ) > 1:
      for mod, node in occ[1:]:
        first = occ[0][1].lineno
        out.append(Finding(
            RULE, mod.path, mod.relpath, node.lineno,
            node.col_offset + 1,
            f'duplicate fault site {name!r} (first at '
            f'{occ[0][0].relpath}:{first}) — arming it would fire two '
            'code paths at once; fault-site names are one-per-site'))
    mod, node = occ[0]
    if registered is not None and name not in registered:
      out.append(Finding(
          RULE, mod.path, mod.relpath, node.lineno, node.col_offset + 1,
          f'fault site {name!r} is not in utils/faults.py '
          'REGISTERED_SITES — add it to the registry (and to the '
          f'{config.failure_doc} fault-site table)'))
    if documented is not None and name not in documented:
      out.append(Finding(
          RULE, mod.path, mod.relpath, node.lineno, node.col_offset + 1,
          f'fault site {name!r} is not documented in '
          f'{config.failure_doc} — add it to the fault-site table '
          '(what it injects, where, typical arming)'))

  if registered is not None:
    for name in sorted(registered - set(sites)):
      out.append(Finding(
          RULE, reg_mod.path, reg_mod.relpath, reg_line, 1,
          f'REGISTERED_SITES entry {name!r} has no fault_point call '
          'site — stale registration; remove it or restore the site'))
  elif registry_mod is not None:
    out.append(Finding(
        RULE, registry_mod.path, registry_mod.relpath, 1, 1,
        'utils/faults.py defines no REGISTERED_SITES frozenset — the '
        'fault-site registry is the anchor this rule checks against'))
  return out


def _parse_registry(registry_mod: Optional[ParsedModule]):
  """(names, lineno, module) from `REGISTERED_SITES = frozenset({...})`,
  or (None, 0, None) when unavailable."""
  if registry_mod is None:
    return None, 0, None
  for node in ast.walk(registry_mod.tree):
    if isinstance(node, ast.Assign):
      names = [t.id for t in node.targets if isinstance(t, ast.Name)]
      if 'REGISTERED_SITES' not in names:
        continue
      try:
        value = ast.literal_eval(node.value)
      except ValueError:
        # frozenset({...}) is a Call — evaluate its literal argument
        if isinstance(node.value, ast.Call) and node.value.args:
          try:
            value = ast.literal_eval(node.value.args[0])
          except ValueError:
            return None, 0, None
        else:
          return None, 0, None
      return set(value), node.lineno, registry_mod
  return None, 0, None


def _documented_names(config: Config) -> Optional[Set[str]]:
  if not config.repo_root:
    return None
  path = os.path.join(config.repo_root, config.failure_doc)
  if not os.path.exists(path):
    return None
  import re
  with open(path, encoding='utf-8') as fh:
    text = fh.read()
  return set(re.findall(r'`([a-z0-9_.]+)`', text))
