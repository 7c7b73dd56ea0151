"""Rule bracket-discipline: opened brackets must close on EVERY path.

The port's observability and fault layers are bracket APIs, as JAX's
are: ``metrics.spans.begin`` returns a token ``spans.end`` must consume,
``metrics.flight.epoch_begin`` returns a record ``flight.epoch_end`` /
``flight.end_for`` must complete, ``utils.faults.arm`` must be met by
``faults.disarm``. A bracket left open on ONE path is worse than no
bracket at all: a prologue raise before the try block leaks the epoch
span onto the thread-context stack and mis-parents every later span; an
allocation between ``epoch_begin`` and its ``try`` leaves the epoch's
flight record open when it fails.

This rule runs the bracket as a dataflow problem on the function CFG
(``flow.py``): a token bound from an opener call is OPEN; a closer call
naming it (or a rebind) closes it; if an open token reaches function
EXIT along any edge (normal fall-through, early return, or an exception
edge out of any statement in between) the opener is a finding. The fix
is always the same and the message says so: move the opener's work
into ``try/finally`` (or the ``with``-form, which closes structurally).

Escapes are quiet: a token that is returned, stored on ``self``,
packed into a container, or handed to a helper call leaves this
function's responsibility and stops being tracked. A bare opener call
whose token is DISCARDED (an expression statement) can never be closed
and is flagged immediately, as is calling a with-only context manager
(``utils.strict.strict_guards``, ``utils.strict.explicit``,
``spans.span``) as a plain statement.
"""
import ast
from typing import Dict, List, Tuple

from . import astutil, flow
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'bracket-discipline'

# (opener names, closer names, what the token is)
_SPECS: Tuple[Tuple[Tuple[str, ...], Tuple[str, ...], str], ...] = (
    (('spans.begin',), ('spans.end',), 'span'),
    (('flight.epoch_begin',), ('flight.epoch_end', 'flight.end_for'),
     'flight record'),
    (('faults.arm',), ('faults.disarm',), 'armed fault region'),
)
# context managers with no token form: a bare call does nothing
_WITH_ONLY = ('strict_guards', 'strict.explicit', 'spans.span')
# every bracket-API entry point: statements that are nothing but these
# calls are assumed exception-safe (closers MUST be — they run inside
# finally blocks by design), so no exception edge leaves them
_BRACKET_API = tuple(n for op, cl, _ in _SPECS for n in op + cl)


def check_package(modules: List[ParsedModule], config: Config):
  findings = []
  for mod in modules:
    if not in_scope(mod.relpath, config.bracket_modules):
      continue
    try:
      findings.extend(_check_module(mod, config))
    except RecursionError:
      pass
  return findings


def _check_module(mod: ParsedModule, config: Config) -> List[Finding]:
  index = astutil.index_of(mod)
  aliases = astutil.aliases_of(mod)
  parents = astutil.parents_of(mod)
  out: List[Finding] = []
  for fi in index.by_qual.values():
    out.extend(_check_function(mod, index, aliases, parents, fi))
  return out


def _call_matches(call: ast.Call, aliases, targets) -> bool:
  name = astutil.canonical(astutil.call_name(call), aliases)
  return astutil.matches(name, targets)


def _spec_of(call: ast.Call, aliases):
  for i, (openers, _closers, _label) in enumerate(_SPECS):
    if _call_matches(call, aliases, openers):
      return i
  return None


def _stmt_of(parents, node):
  while node is not None and not isinstance(node, ast.stmt):
    node = parents.get(node)
  return node


def _bracket_only_stmt(stmt: ast.stmt, aliases) -> bool:
  """True if the statement is a plain call (or tuple-assign of calls)
  whose every call is a bracket-API entry point — such statements are
  treated as non-raising."""
  if isinstance(stmt, (ast.Expr, ast.Assign)):
    val = stmt.value
  else:
    return False
  exprs = val.elts if isinstance(val, ast.Tuple) else [val]
  if not exprs:
    return False
  for e in exprs:
    if not (isinstance(e, ast.Call) and
            _call_matches(e, aliases, _BRACKET_API)):
      return False
  return True


def _check_function(mod, index, aliases, parents,
                    fi: astutil.FuncInfo) -> List[Finding]:
  # ---- collect opener sites in this function (own nodes only)
  tracked: Dict[str, Tuple[ast.Call, int]] = {}   # name -> (call, spec)
  findings: List[Finding] = []
  opener_calls = []
  for node in index.own_nodes(fi):
    if not isinstance(node, ast.Call):
      continue
    spec = _spec_of(node, aliases)
    if spec is not None:
      opener_calls.append((node, spec))
    elif isinstance(node.func, (ast.Name, ast.Attribute)) and \
        _call_matches(node, aliases, _WITH_ONLY):
      stmt = _stmt_of(parents, node)
      if isinstance(stmt, ast.Expr) and stmt.value is node:
        findings.append(Finding(
            RULE, mod.path, mod.relpath, node.lineno,
            node.col_offset + 1,
            f'{astutil.call_name(node)}(...) called as a bare statement '
            'does nothing — it is a context manager; use the with-form',
            symbol=fi.qualname))

  if not opener_calls:
    return findings

  for call, spec in opener_calls:
    stmt = _stmt_of(parents, call)
    if stmt is None:
      continue
    label = _SPECS[spec][2]
    if isinstance(stmt, (ast.With, ast.AsyncWith)) and \
        any(i.context_expr is call for i in stmt.items):
      continue   # structurally closed
    if isinstance(stmt, ast.Expr) and stmt.value is call:
      findings.append(Finding(
          RULE, mod.path, mod.relpath, call.lineno, call.col_offset + 1,
          f'{label} token discarded — bind the result of '
          f'{astutil.call_name(call)}(...) and close it in a finally',
          symbol=fi.qualname))
      continue
    name = None
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
      t = stmt.targets[0]
      if stmt.value is call and isinstance(t, ast.Name):
        name = t.id
      elif isinstance(stmt.value, ast.Tuple) and \
          isinstance(t, ast.Tuple) and \
          len(stmt.value.elts) == len(t.elts):
        for v, tt in zip(stmt.value.elts, t.elts):
          if v is call and isinstance(tt, ast.Name):
            name = tt.id
    if name is None:
      continue   # returned / stored / passed on: escapes, err quiet
    # two openers into one name: track the last only (quiet)
    tracked[name] = (call, spec)

  if not tracked:
    return findings

  # ---- dataflow: which tokens may still be open at EXIT
  closers = {name: _SPECS[spec][1] for name, (_c, spec) in tracked.items()}

  def closed_or_escaped(stmt) -> set:
    """Token names this statement closes (closer call argument) or
    hands off (argument to any other call / returned / yielded)."""
    gone = set()
    for call in flow.stmt_calls(stmt):
      arg_names = {a.id for a in call.args if isinstance(a, ast.Name)}
      arg_names |= {k.value.id for k in call.keywords
                    if isinstance(k.value, ast.Name)}
      for name in arg_names & set(closers):
        gone.add(name)   # closer closes it; anything else takes it over
    if isinstance(stmt, ast.Return) and stmt.value is not None:
      for n in ast.walk(stmt.value):
        if isinstance(n, ast.Name) and n.id in closers:
          gone.add(n.id)
    return gone

  gen: Dict[int, str] = {}
  for name, (call, _spec) in tracked.items():
    stmt = _stmt_of(parents, call)
    gen[id(stmt)] = name

  def transfer(n, stmt, state):
    if stmt is None:
      return state
    gone = closed_or_escaped(stmt)
    state = frozenset(e for e in state if e not in gone)
    writes = flow.stmt_writes(stmt)
    state = frozenset(e for e in state
                      if e not in writes or gen.get(id(stmt)) == e)
    name = gen.get(id(stmt))
    if name is not None:
      state = state | {name}
    return state

  def exc_transfer(n, stmt, state):
    # an opener that raised never bound its token; a closer that raised
    # is treated as having closed (quiet side). Statements that are
    # nothing but bracket-API calls are assumed not to raise at all —
    # the merge is a union, so contributing the empty set makes that
    # impossible edge vacuous.
    if stmt is None:
      return state
    if _bracket_only_stmt(stmt, aliases):
      return frozenset()
    gone = closed_or_escaped(stmt)
    return frozenset(e for e in state if e not in gone)

  cfg = flow.build_cfg(fi.node)
  in_s = flow.forward(cfg, frozenset(), transfer, exc_transfer)
  for name in sorted(in_s[flow.EXIT]):
    call, spec = tracked[name]
    label = _SPECS[spec][2]
    closer_names = ' / '.join(_SPECS[spec][1])
    findings.append(Finding(
        RULE, mod.path, mod.relpath, call.lineno, call.col_offset + 1,
        f"{label} '{name}' opened here may not be closed on every "
        f'path (exception or early return) — close it with '
        f'{closer_names} in a try/finally, or use the with-form',
        symbol=fi.qualname))
  findings.sort(key=lambda f: (f.line, f.col))
  return findings
