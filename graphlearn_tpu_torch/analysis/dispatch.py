"""Rule dispatch-instrumentation: every graph replay in a hot module must
be counted.

The port's dispatch budgets (``utils.trace.count_dispatches``, the
flight records' ``dispatch`` field, the ``programs`` registry) count
one dispatch per graph replay or eager call at a site. They are only
meaningful if EVERY replay of a captured chunk calls
``utils.trace.record_dispatch`` at its dispatch site (or sits behind
``wrap_dispatch``): an unrecorded ``graph.replay()`` silently deflates
the counted budget while the epoch quietly pays more launches than it
asserts.

Model (per module, name-based dataflow):

  * HANDLES are values that hold a captured graph: ``torch.cuda.
    CUDAGraph()`` results, the first element of what ``capture_chunk``
    returns, and what a FACTORY returns (a function whose return value
    is a handle).
  * Handles propagate through local names, ``self.attr`` stores,
    container stores and reads (``self._graphs[k] = g``,
    ``self._graphs.get(k)``), records packing a handle
    (``_ChunkGraph(graph, ...)``) and attributes of a handle
    (``g.graph``).
  * A ``.replay()`` on a handle is a DISPATCH SITE. It is fine when
    ``record_dispatch`` / ``wrap_dispatch`` appears lexically before it
    in the same function (inside the same loop, for a site in a loop:
    the replay runs every iteration), or when the enclosing function is itself
    called elsewhere in the module: it is then a replay WRAPPER whose
    own call sites are checked the same way (the fixpoint walks the
    wrapping chain up to wherever the record must live, as JAX's rule
    does for jitted wrappers).
  * Anything left is a finding at the original site.
"""
import ast
from typing import Dict, List, Optional, Set

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'dispatch-instrumentation'

_INSTRUMENT_CALLS = ('record_dispatch', 'wrap_dispatch')
_GRAPH_CTORS = ('torch.cuda.CUDAGraph', 'cuda.CUDAGraph', 'CUDAGraph')
_CONTAINER_READS = ('get', 'pop', 'setdefault')
# calls whose tuple result holds a captured graph first
_GRAPH_FACTORIES = ('capture_chunk',)


def check_package(modules: List[ParsedModule], config: Config):
  findings = []
  for mod in modules:
    if not in_scope(mod.relpath, config.dispatch_modules):
      continue
    findings.extend(_check_module(mod))
  return findings


class _ModuleState:
  def __init__(self, mod: ParsedModule):
    self.mod = mod
    self.index = astutil.index_of(mod)
    self.aliases = astutil.aliases_of(mod)
    self.parents = astutil.parents_of(mod)
    self.attr_handles: Set[str] = set()        # self.<attr> / x.<attr>
    self.container_attrs: Set[str] = set()     # self.<attr>[...] handles
    self.factories: Set[str] = set()           # defs returning a handle
    self.local_handles: Dict[str, Set[str]] = {}  # fn qual -> names
    self.wrappers: Set[str] = set()            # defs that replay

  def scope_of(self, node) -> str:
    fi = astutil.enclosing_function(self.index, node, self.parents)
    return fi.qualname if fi else '<module>'


def _check_module(mod: ParsedModule) -> List[Finding]:
  st = _ModuleState(mod)
  _seed_handles(st)
  out = []
  for call, qual in _propagate(st):
    out.append(Finding(
        RULE, mod.path, mod.relpath, call.lineno, call.col_offset + 1,
        'captured graph replayed without instrumentation — call '
        'utils.trace.record_dispatch(<site>) before the replay (or '
        'build the callable with wrap_dispatch) so the epoch dispatch '
        'budgets stay exact', symbol=qual))
  return out


def _is_handle_expr(st: _ModuleState, node: ast.AST, scope: str) -> bool:
  """Does this expression evaluate to a captured graph (or a record
  holding one)?"""
  if isinstance(node, ast.Call):
    func = node.func
    name = astutil.canonical(astutil.call_name(node), st.aliases)
    seg = astutil.last_segment(name)
    if astutil.matches(name, _GRAPH_CTORS) or seg in _GRAPH_FACTORIES:
      return True
    if seg == 'wrap_dispatch':
      return False    # instrumented at build: never a violation
    if seg in st.factories:
      return True
    if isinstance(func, ast.Attribute) and \
        func.attr in _CONTAINER_READS and \
        _is_container(st, func.value, scope):
      return True
    # a record packing a handle (a NamedTuple / class of this module)
    if seg and seg.lstrip('_')[:1].isupper() and any(
        _is_handle_expr(st, a, scope) for a in node.args):
      return True
    return False
  if isinstance(node, ast.Name):
    return node.id in st.local_handles.get(scope, set()) or \
        node.id in st.local_handles.get('<module>', set())
  if isinstance(node, ast.Attribute):
    return node.attr in st.attr_handles or \
        _is_handle_expr(st, node.value, scope)
  if isinstance(node, ast.Subscript):
    return _is_container(st, node.value, scope)
  if isinstance(node, ast.Tuple):
    return any(_is_handle_expr(st, e, scope) for e in node.elts)
  return False


def _is_container(st: _ModuleState, node: ast.AST, scope: str) -> bool:
  if isinstance(node, ast.Attribute):
    return node.attr in st.container_attrs
  if isinstance(node, ast.Name):
    return node.id in st.local_handles.get(scope, set())
  return False


def _seed_handles(st: _ModuleState):
  """Handles into names, attributes, containers and factories, to a
  fixpoint."""
  changed = True
  while changed:
    changed = False
    for node in ast.walk(st.mod.tree):
      if isinstance(node, ast.Assign):
        scope = st.scope_of(node)
        value = node.value
        if not _is_handle_expr(st, value, scope):
          continue
        for t in node.targets:
          # a factory's tuple result: only its first element is a graph
          if isinstance(t, ast.Tuple) and isinstance(value, ast.Call) and \
              astutil.last_segment(astutil.call_name(value)) in \
              _GRAPH_FACTORIES and t.elts:
            t = t.elts[0]
          changed |= _bind_target(st, t, scope)
      elif isinstance(node, ast.Return) and node.value is not None:
        scope = st.scope_of(node)
        if scope != '<module>' and \
            _is_handle_expr(st, node.value, scope):
          fn_name = scope.rsplit('.', 1)[-1]
          if fn_name not in st.factories:
            st.factories.add(fn_name)
            changed = True


def _bind_target(st: _ModuleState, t: ast.AST, scope: str) -> bool:
  if isinstance(t, ast.Name):
    s = st.local_handles.setdefault(scope, set())
    if t.id not in s:
      s.add(t.id)
      return True
  elif isinstance(t, ast.Attribute):
    if t.attr not in st.attr_handles:
      st.attr_handles.add(t.attr)
      return True
  elif isinstance(t, ast.Subscript):
    base = t.value
    if isinstance(base, ast.Attribute) and \
        base.attr not in st.container_attrs:
      st.container_attrs.add(base.attr)
      return True
    if isinstance(base, ast.Name):
      return _bind_target(st, base, scope)
  elif isinstance(t, ast.Tuple):
    return any([_bind_target(st, e, scope) for e in t.elts])
  return False


def _dispatch_sites(st: _ModuleState):
  """(call, enclosing qualname) of uninstrumented replays and wrapper
  calls."""
  sites = []
  for node in ast.walk(st.mod.tree):
    if not isinstance(node, ast.Call):
      continue
    func = node.func
    scope = st.scope_of(node)
    is_site = (isinstance(func, ast.Attribute) and func.attr == 'replay'
               and _is_handle_expr(st, func.value, scope))
    if not is_site:
      callee = astutil.last_segment(astutil.dotted_name(func))
      is_site = callee in st.wrappers and (
          isinstance(func, ast.Name) or (
              isinstance(func, ast.Attribute) and
              isinstance(func.value, ast.Name) and
              func.value.id in ('self', 'cls')))
    if not is_site:
      continue
    fi = astutil.enclosing_function(st.index, node, st.parents)
    if _instrumented_before(st, fi, node):
      continue
    sites.append((node, fi.qualname if fi else '<module>'))
  return sites


def _propagate(st: _ModuleState):
  """Fixpoint: a function holding an unrecorded site that is called
  elsewhere in the module becomes a wrapper (its call sites take over),
  until no new wrapper appears. Returns the surviving sites."""
  for _round in range(20):
    sites = _dispatch_sites(st)
    new = False
    for _call, qual in sites:
      if qual == '<module>':
        continue
      fi = st.index.by_qual.get(qual)
      name = qual.rsplit('.', 1)[-1]
      if fi is not None and name not in st.wrappers and \
          _is_called(st, fi):
        st.wrappers.add(name)
        new = True
    if not new:
      break
  return [s for s in _dispatch_sites(st) if not _excused(st, s)]


def _is_called(st: _ModuleState, fi: astutil.FuncInfo) -> bool:
  """Is this def called (or referenced) elsewhere in the module?"""
  name = fi.node.name
  for node in ast.walk(st.mod.tree):
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) and \
        node.id == name:
      f = astutil.enclosing_function(st.index, node, st.parents)
      if f is None or f.qualname != fi.qualname:
        return True
    if isinstance(node, ast.Attribute) and node.attr == name and \
        not isinstance(node.ctx, ast.Store):
      return True
  return False


def _excused(st: _ModuleState, site) -> bool:
  _call, qual = site
  return qual != '<module>' and qual.rsplit('.', 1)[-1] in st.wrappers


def _innermost_loop(st: _ModuleState, node: ast.AST, stop: ast.AST):
  n = st.parents.get(node)
  while n is not None and n is not stop:
    if isinstance(n, (ast.For, ast.AsyncFor, ast.While)):
      return n
    n = st.parents.get(n)
  return None


def _inside(st: _ModuleState, node: ast.AST, outer: ast.AST) -> bool:
  n = st.parents.get(node)
  while n is not None:
    if n is outer:
      return True
    n = st.parents.get(n)
  return False


def _instrumented_before(st: _ModuleState, fi: Optional[astutil.FuncInfo],
                         call: ast.Call) -> bool:
  """A record lexically before the site in its function; for a site in
  a loop, inside that loop (a record before the loop counts once, the
  replay every iteration)."""
  if fi is None:
    return False
  loop = _innermost_loop(st, call, fi.node)
  for node in st.index.own_nodes(fi):
    if isinstance(node, ast.Call) and \
        astutil.last_segment(astutil.call_name(node)) in \
        _INSTRUMENT_CALLS and node.lineno <= call.lineno and \
        (loop is None or _inside(st, node, loop)):
      return True
  return False
