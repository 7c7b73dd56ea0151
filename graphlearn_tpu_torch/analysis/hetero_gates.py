"""Rule hetero-gate: hetero capability refusals go through CapacityPlan.

A capability gap on a typed dataset must either

  1. raise :class:`~graphlearn_tpu_torch.sampler.capacity.CapacityPlanError`,
     the typed error that names the consumer, the missing plan input,
     and the doc anchor (docs/capacity_plans.md), or
  2. carry a ``# graftlint: allow[hetero-gate] <reason>`` pragma
     explaining why the gate is a real semantic boundary and not an
     unmigrated fast path.

The rule flags a ``raise`` of anything else, or a ``warnings.warn``,
appearing as a DIRECT statement of an ``if`` branch whose test
mentions ``is_hetero`` (attribute, name, or ``getattr(...,
'is_hetero', ...)``). Direct statements only: the canonical gate shape
is a one-line refusal, and deeper hetero branches legitimately raise
for non-typed reasons.
"""
import ast
from typing import List

from .core import Config, Finding, ParsedModule

RULE = 'hetero-gate'

_MSG = ('{what} gated on is_hetero — hetero capability refusals must '
        'raise CapacityPlanError naming the consumer and the missing '
        'plan input (sampler/capacity.py, docs/capacity_plans.md), or '
        'carry a `# graftlint: allow[hetero-gate] <reason>` pragma for '
        'a real semantic boundary')

#: the module that OWNS the typed-error contract — its own internal
#: gates are the contract, not a violation of it
_EXEMPT = ('sampler/capacity.py',)


def _mentions_is_hetero(test: ast.AST) -> bool:
  for node in ast.walk(test):
    if isinstance(node, ast.Attribute) and node.attr == 'is_hetero':
      return True
    if isinstance(node, ast.Name) and node.id == 'is_hetero':
      return True
    if isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Name) and node.func.id == 'getattr' and \
        any(isinstance(a, ast.Constant) and a.value == 'is_hetero'
            for a in node.args):
      return True
  return False


def _exc_name(node: ast.Raise) -> str:
  exc = node.exc
  if isinstance(exc, ast.Call):
    exc = exc.func
  if isinstance(exc, ast.Attribute):
    return exc.attr
  if isinstance(exc, ast.Name):
    return exc.id
  return ''


def _is_warn_call(stmt: ast.stmt) -> bool:
  if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
    return False
  f = stmt.value.func
  name = f.attr if isinstance(f, ast.Attribute) else \
      f.id if isinstance(f, ast.Name) else ''
  return name == 'warn'


def check_package(modules: List[ParsedModule], config: Config):
  out: List[Finding] = []
  for mod in modules:
    if mod.relpath in _EXEMPT:
      continue
    for node in ast.walk(mod.tree):
      if not isinstance(node, ast.If) or \
          not _mentions_is_hetero(node.test):
        continue
      for stmt in list(node.body) + list(node.orelse):
        what = None
        if isinstance(stmt, ast.Raise) and stmt.exc is not None:
          name = _exc_name(stmt)
          if name != 'CapacityPlanError':
            what = f'`raise {name or "..."}`'
        elif _is_warn_call(stmt):
          what = '`warnings.warn`'
        if what:
          out.append(Finding(RULE, mod.path, mod.relpath, stmt.lineno,
                             stmt.col_offset + 1,
                             _MSG.format(what=what)))
  return out
