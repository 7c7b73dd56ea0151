"""Shared AST machinery for graftlint checkers.

Everything here is best-effort, per-module, name-based dataflow: the
goal is catching the regressions this codebase's conventions make
likely, not soundness. Where resolution fails we err on the quiet side
(a missed edge), and the conventions themselves close most of the gap.

The torch notion of TRACED scope is the code that runs inside a captured
step, where a host sync either breaks the capture or, on the eager warm-up
and the CPU, silently costs a round trip per step. Its roots:

  * the callable handed to ``capture_chunk(stream, body)``
    (``loader/scan_epoch.py``); a lambda there roots every function it
    references;
  * the bodies of ``with torch.cuda.graph(...):`` blocks (see
    :func:`graph_blocks`);
  * the step functions ``Config.traced_step_functions`` names, wherever a
    hot module defines them (the chunk bodies call across modules);
  * the JAX package's nested-def convention: a closure inside a builder
    is a step body (the sample+collate bodies), unless it records
    dispatches (a host dispatch wrapper).

and a def referenced inside a traced function is traced too.
"""
import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

# calls whose callable argument runs captured: name -> its position
TRACING_CALLS = {'capture_chunk': 1}
# context managers whose body is captured
GRAPH_CONTEXTS = ('torch.cuda.graph', 'cuda.graph')


def dotted_name(node: ast.AST) -> Optional[str]:
  """'torch.cuda.graph' for Attribute/Name chains, else None."""
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
    return '.'.join(reversed(parts))
  return None


def call_name(call: ast.Call) -> Optional[str]:
  return dotted_name(call.func)


def last_segment(name: Optional[str]) -> Optional[str]:
  return name.rsplit('.', 1)[-1] if name else None


def matches(name: Optional[str], targets) -> bool:
  """Dotted-name match, exact or by trailing segments ('random.split'
  matches 'graphlearn_tpu_torch.random.split'). A BARE name only matches
  exactly, so a local helper never matches a dotted target by its last
  segment alone."""
  if not name:
    return False
  for t in targets:
    if name == t or name.endswith('.' + t) or \
        ('.' in name and t.endswith('.' + name)):
      return True
  return False


def import_aliases(tree: ast.AST) -> Dict[str, str]:
  """name -> canonical dotted path, from this module's imports.
  Relative imports keep their trailing module path ('..utils.strict'
  -> 'utils.strict'), enough for suffix matching."""
  out: Dict[str, str] = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if a.asname:
          out[a.asname] = a.name
    elif isinstance(node, ast.ImportFrom):
      base = (node.module or '').lstrip('.')
      for a in node.names:
        full = f'{base}.{a.name}' if base else a.name
        out[a.asname or a.name] = full
  return out


def canonical(name: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
  """Expand the leading alias segment: 'np.asarray' -> 'numpy.asarray'."""
  if not name:
    return None
  head, _, rest = name.partition('.')
  base = aliases.get(head, head)
  return f'{base}.{rest}' if rest else base


# ------------------------------------------------------------ function index

class FuncInfo:
  __slots__ = ('node', 'qualname', 'parent', 'nested', 'is_nested')

  def __init__(self, node, qualname, parent):
    self.node = node
    self.qualname = qualname
    self.parent = parent          # enclosing FuncInfo or None
    self.nested: List['FuncInfo'] = []
    self.is_nested = parent is not None


class FuncIndex:
  """All function defs in a module, with name->defs lookup and which
  nested defs each def may return (builders returning step bodies)."""

  def __init__(self, tree: ast.AST):
    self.by_qual: Dict[str, FuncInfo] = {}
    self.by_name: Dict[str, List[FuncInfo]] = {}
    self._returned: Dict[str, Set[str]] = {}
    self._walk(tree, None, '')

  def returned_defs(self, fi: FuncInfo) -> Set[str]:
    """Qualnames of the nested defs ``fi`` may return (computed on
    first use: only the traced-set closure asks)."""
    if fi.qualname not in self._returned:
      self._returned[fi.qualname] = self._returned_defs(fi)
    return self._returned[fi.qualname]

  def _walk(self, node, parent: Optional[FuncInfo], prefix: str):
    for child in ast.iter_child_nodes(node):
      if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
        qual = f'{prefix}{child.name}'
        # a def whose immediate container is a class is a method, not a
        # closure of `parent`
        method = isinstance(node, ast.ClassDef)
        fi = FuncInfo(child, qual, None if method else parent)
        self.by_qual[qual] = fi
        self.by_name.setdefault(child.name, []).append(fi)
        if fi.parent is not None:
          fi.parent.nested.append(fi)
        self._walk(child, fi, qual + '.')
      elif isinstance(child, ast.ClassDef):
        self._walk(child, None, f'{prefix}{child.name}.')
      else:
        # defs under if/try/with keep the same enclosing function
        self._walk(child, parent, prefix)

  def _returned_defs(self, fi: FuncInfo) -> Set[str]:
    local_defs = {n.node.name: n.qualname for n in fi.nested}
    var_defs: Dict[str, str] = {}
    for node in self.own_nodes(fi):
      if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
        if node.value.id in local_defs:
          for t in node.targets:
            if isinstance(t, ast.Name):
              var_defs[t.id] = local_defs[node.value.id]
    out: Set[str] = set()

    def resolve(expr):
      if isinstance(expr, ast.Name):
        q = local_defs.get(expr.id) or var_defs.get(expr.id)
        if q:
          out.add(q)
      elif isinstance(expr, ast.Tuple):
        for e in expr.elts:
          resolve(e)

    for node in self.own_nodes(fi):
      if isinstance(node, ast.Return) and node.value is not None:
        resolve(node.value)
    return out

  def own_nodes(self, fi: FuncInfo) -> Iterator[ast.AST]:
    """Nodes of ``fi`` excluding nested function bodies."""
    return own_nodes(fi.node)

  def lookup(self, node: ast.AST) -> Optional[FuncInfo]:
    for fi in self.by_name.get(getattr(node, 'name', ''), []):
      if fi.node is node:
        return fi
    return None


def own_nodes(node: ast.AST) -> Iterator[ast.AST]:
  """Nodes under ``node`` excluding nested function and class bodies."""
  stack = list(ast.iter_child_nodes(node))
  while stack:
    n = stack.pop()
    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                      ast.ClassDef)):
      continue
    yield n
    stack.extend(ast.iter_child_nodes(n))


def _cached(mod, key, build):
  val = mod.cache.get(key)
  if val is None:
    val = mod.cache[key] = build(mod.tree)
  return val


def index_of(mod) -> 'FuncIndex':
  """The module's :class:`FuncIndex`, built once for every rule."""
  return _cached(mod, 'index', FuncIndex)


def aliases_of(mod) -> Dict[str, str]:
  """The module's :func:`import_aliases`, built once."""
  return _cached(mod, 'aliases', import_aliases)


def parents_of(mod) -> Dict[ast.AST, ast.AST]:
  """The module's :func:`parent_map`, built once."""
  return _cached(mod, 'parents', parent_map)


# --------------------------------------------------------------- bindings

def local_bindings(index: FuncIndex,
                   fi: FuncInfo) -> Dict[str, Tuple[str, str]]:
  """name -> (kind, target) for assignments visible in ``fi``'s scope
  chain. kind 'ref': `x = self._foo` / `x = foo`: calling x calls
  target. kind 'result': `x = self._foo(...)`: calling x calls what
  target RETURNS. Inner scopes shadow outer ones."""
  out: Dict[str, Tuple[str, str]] = {}
  chain = []
  f = fi
  while f is not None:
    chain.append(f)
    f = f.parent
  for f in reversed(chain):
    for node in index.own_nodes(f):
      if not isinstance(node, ast.Assign):
        continue
      src = node.value
      entry = None
      if isinstance(src, ast.Call):
        seg = last_segment(call_name(src))
        if seg:
          entry = ('result', seg)
      elif isinstance(src, (ast.Attribute, ast.Name)):
        seg = last_segment(dotted_name(src))
        if seg:
          entry = ('ref', seg)
      if entry is None:
        continue
      for t in node.targets:
        if isinstance(t, ast.Name):
          out[t.id] = entry
  return out


# --------------------------------------------------------------- traced set

def _traced_target(call: ast.Call, aliases) -> Optional[ast.AST]:
  """The callable argument a capture call runs captured, or None."""
  name = canonical(call_name(call), aliases)
  for target, pos in TRACING_CALLS.items():
    if matches(name, (target,)):
      for kw in call.keywords:
        if kw.arg == 'body':
          return kw.value
      return call.args[pos] if len(call.args) > pos else None
  return None


def graph_blocks(tree: ast.AST, aliases) -> List[ast.AST]:
  """``with torch.cuda.graph(...):`` statements: their bodies run
  captured."""
  out = []
  for node in ast.walk(tree):
    if isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(i.context_expr, ast.Call) and
        matches(canonical(call_name(i.context_expr), aliases),
                GRAPH_CONTEXTS) for i in node.items):
      out.append(node)
  return out


def _referenced_names(node: ast.AST, params: Set[str]) -> Set[str]:
  """Names a lambda or a statement list may call: bare loads (minus the
  lambda's parameters) and attribute names."""
  out = set()
  for n in own_nodes(node):
    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
        n.id not in params:
      out.add(n.id)
    elif isinstance(n, ast.Attribute):
      out.add(n.attr)
  return out


def traced_functions(index: FuncIndex, tree: ast.AST,
                     aliases: Dict[str, str],
                     step_functions=()) -> Set[str]:
  """Qualnames of functions whose bodies run inside a captured step (the
  roots in the module docstring).

  Closure: a def referenced inside a traced function is traced, and a
  call through a 'result' binding traces the bound builder's RETURNED
  defs (`body = self._make_body()` => _make_body's nested `body`)."""
  traced: Set[str] = set()
  pending: List[FuncInfo] = []

  def mark(fi: Optional[FuncInfo]):
    if fi is not None and fi.qualname not in traced:
      traced.add(fi.qualname)
      pending.append(fi)

  def mark_name(name: Optional[str]):
    for fi in index.by_name.get(name or '', []):
      mark(fi)

  def mark_expr(target: ast.AST):
    if isinstance(target, ast.Lambda):
      a = target.args
      params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
      for name in _referenced_names(target.body, params):
        mark_name(name)
      return
    if isinstance(target, ast.Call) and target.args and matches(
        canonical(call_name(target), aliases),
        {'functools.partial', 'partial'}):
      target = target.args[0]
    mark_name(last_segment(dotted_name(target)))

  # call-argument roots: capture_chunk(stream, body) and the like
  for node in ast.walk(tree):
    if isinstance(node, ast.Call):
      target = _traced_target(node, aliases)
      if target is not None:
        mark_expr(target)

  # captured with-bodies: what they call runs captured
  blocks = graph_blocks(tree, aliases)
  parents = parent_map(tree) if blocks else {}
  for block in blocks:
    # the enclosing function's parameters and locals are data, not defs
    owner = enclosing_function(index, block, parents)
    bound = _locally_bound_names(index, owner) if owner else set()
    for stmt in block.body:
      for name in _referenced_names(stmt, bound):
        mark_name(name)

  # the step functions the config names
  for name in step_functions:
    mark_name(name)

  # nested-def convention, minus host dispatch wrappers
  for fi in index.by_qual.values():
    if fi.is_nested and not _is_host_wrapper(index, fi):
      mark(fi)

  while pending:
    fi = pending.pop()
    bindings = local_bindings(index, fi)
    shadowed = _locally_bound_names(index, fi)
    for node in index.own_nodes(fi):
      name = None
      is_bare = False
      if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        name, is_bare = node.id, True
      elif isinstance(node, ast.Attribute):
        name = node.attr
      if not name:
        continue
      kind_target = bindings.get(name)
      if kind_target is not None:
        kind, seg = kind_target
        if kind == 'ref':
          mark_name(seg)
        else:   # result-of-call: the builder's returned bodies run traced
          for builder in index.by_name.get(seg, []):
            for q in index.returned_defs(builder):
              mark(index.by_qual.get(q))
        continue
      if is_bare and name in shadowed:
        # a parameter / local variable shadows any same-named module
        # function: loading it is not a function reference
        continue
      mark_name(name)
    # closures of a traced function are traced
    for sub in fi.nested:
      mark(sub)
  return traced


def _locally_bound_names(index: FuncIndex, fi: FuncInfo) -> Set[str]:
  """Names bound as data (params, assignment targets, loop/with/except
  targets) anywhere in ``fi``'s enclosing-def chain. Nested function
  defs are deliberately NOT included: referencing one by name IS a
  traced-callable reference."""
  out: Set[str] = set()
  f = fi
  while f is not None:
    a = f.node.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs +
                [a.vararg, a.kwarg]):
      if arg is not None:
        out.add(arg.arg)
    for node in index.own_nodes(f):
      if isinstance(node, ast.Name) and \
          isinstance(node.ctx, (ast.Store, ast.Del)):
        out.add(node.id)
    f = f.parent
  return out


def _is_host_wrapper(index: FuncIndex, fi: FuncInfo) -> bool:
  """A nested def that performs host-side dispatch bookkeeping or
  replays a graph."""
  for node in index.own_nodes(fi):
    if isinstance(node, ast.Call):
      seg = last_segment(call_name(node))
      if seg in ('record_dispatch', 'wrap_dispatch', 'replay'):
        return True
  return False


# ------------------------------------------------------------------ parents

def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
  parents: Dict[ast.AST, ast.AST] = {}
  for node in ast.walk(tree):
    for child in ast.iter_child_nodes(node):
      parents[child] = node
  return parents


def enclosing_function(index: FuncIndex, node: ast.AST,
                       parents: Dict[ast.AST, ast.AST]) -> Optional[FuncInfo]:
  n = parents.get(node)
  while n is not None:
    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
      return index.lookup(n)
    n = parents.get(n)
  return None
