"""Rule lock-discipline: shared state stays under its lock; lock order
is acyclic.

The port's host threads (the chunk stagers, the checkpoint writer, the
rotation and retune schedulers, the serving dispatcher, the RPC threads
and the server's producers) share state through a handful of known
fields, each guarded by one lock. A field the comments SAY is
lock-guarded, touched on one path without the lock, is a race no test
reliably shows. This rule turns the comment into a checked annotation:

* ``# graftlint: shared[<lock>]`` on the field's defining assignment
  (``self._plan = ...`` in ``__init__``, a class attribute, or a
  module-level global) registers it: every later read/write of that
  field must sit inside ``with self.<lock>:`` (or ``with <lock>:`` for
  globals), inside a method annotated ``# graftlint: locked[<lock>]``
  (callee assumes the caller holds it, and every intra-class call
  site of such a method is checked to actually hold it), or in
  ``__init__`` before the object escapes. A ``threading.Condition``
  built over the lock counts as the lock. A global may name a lock of
  another module by its dotted path (``shared[kernels.COUNT_LOCK]``,
  held by ``with kernels.COUNT_LOCK:``): the port's launch counters.

* The lock-order graph: every ``with``-acquisition nested inside
  another (directly, or transitively through same-class method calls
  and same/imported-module function calls) adds an ordering edge.
  A cycle across the package is a finding (the classic ABBA deadlock),
  reported once per strongly-connected component.

Annotation-driven by design: the rule is silent on unannotated state,
so adopting it is incremental and false positives are opt-in. Lock
identity is name-based (``self._lock`` in class C of module M), the
same approximation every other graftlint rule makes.
"""
import ast
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'lock-discipline'

_LOCK_CTORS = ('threading.Lock', 'threading.RLock', 'threading.Condition',
               'Lock', 'RLock', 'Condition')


def check_package(modules: List[ParsedModule], config: Config):
  findings: List[Finding] = []
  states = []
  for mod in modules:
    if not in_scope(mod.relpath, config.lock_modules):
      continue
    try:
      st = _ModState(mod)
      states.append(st)
      findings.extend(_check_shared(st))
    except RecursionError:
      pass
  findings.extend(_check_lock_order(states))
  return findings


def _norm_lock(arg: str) -> str:
  arg = arg.strip()
  return arg[5:] if arg.startswith('self.') else arg


class _ModState:
  def __init__(self, mod: ParsedModule):
    self.mod = mod
    self.index = astutil.index_of(mod)
    self.aliases = astutil.aliases_of(mod)
    self.parents = astutil.parents_of(mod)
    # registered shared fields: (class or None, field) -> lock name
    self.shared: Dict[Tuple[Optional[str], str], str] = {}
    # methods annotated locked[lock]: qualname -> lock name
    self.locked: Dict[str, str] = {}
    # declared lock objects: class -> {attr}, plus module-level names
    self.class_locks: Dict[str, Set[str]] = {}
    self.module_locks: Set[str] = set()
    # Condition-over-lock aliases: (class, attr) -> guarded attr
    self.cond_alias: Dict[Tuple[Optional[str], str], str] = {}
    self._scan_locks()
    self._scan_annotations()

  # -- structure helpers

  def class_of(self, node) -> Optional[str]:
    n = self.parents.get(node)
    while n is not None:
      if isinstance(n, ast.ClassDef):
        return n.name
      n = self.parents.get(n)
    return None

  def _scan_locks(self):
    for node in ast.walk(self.mod.tree):
      if not isinstance(node, ast.Assign) or \
          not isinstance(node.value, ast.Call):
        continue
      name = astutil.canonical(astutil.call_name(node.value),
                               self.aliases)
      if not astutil.matches(name, _LOCK_CTORS):
        continue
      is_cond = astutil.last_segment(name) == 'Condition'
      wraps = None
      if is_cond and node.value.args:
        a0 = node.value.args[0]
        if isinstance(a0, ast.Attribute) and \
            isinstance(a0.value, ast.Name) and a0.value.id == 'self':
          wraps = a0.attr
        elif isinstance(a0, ast.Name):
          wraps = a0.id
      for t in node.targets:
        if isinstance(t, ast.Attribute) and \
            isinstance(t.value, ast.Name) and t.value.id == 'self':
          cls = self.class_of(node)
          if cls:
            self.class_locks.setdefault(cls, set()).add(t.attr)
            if wraps:
              self.cond_alias[(cls, t.attr)] = wraps
        elif isinstance(t, ast.Name):
          cls = self.class_of(node)
          if cls is None:
            self.module_locks.add(t.id)
            if wraps:
              self.cond_alias[(None, t.id)] = wraps

  def _stmt_at(self, line: int) -> Optional[ast.stmt]:
    best = None
    for node in ast.walk(self.mod.tree):
      if isinstance(node, ast.stmt) and \
          node.lineno <= line <= (node.end_lineno or node.lineno):
        if best is None or node.lineno >= best.lineno:
          best = node
    return best

  def _scan_annotations(self):
    for line, entries in self.mod.annotations.items():
      for kind, arg in entries:
        if kind == 'locked':
          stmt = self._stmt_at(line)
          if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = self.index.lookup(stmt)
            if fi is not None:
              self.locked[fi.qualname] = _norm_lock(arg)
        elif kind == 'shared':
          stmt = self._stmt_at(line)
          if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
          targets = stmt.targets if isinstance(stmt, ast.Assign) \
              else [stmt.target]
          for t in targets:
            if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == 'self':
              cls = self.class_of(stmt)
              if cls:
                self.shared[(cls, t.attr)] = _norm_lock(arg)
            elif isinstance(t, ast.Name):
              cls = self.class_of(stmt)
              # a bare-name target inside a class body is a class
              # attribute; at module level it is a global
              self.shared[(cls, t.id)] = _norm_lock(arg)

  # -- lock-holding queries

  def _holds(self, cls: Optional[str], attr_or_name: str,
             lock: str) -> bool:
    """Does acquiring ``attr_or_name`` (in class ``cls``) hold
    ``lock``? Identity or a Condition built over it."""
    if attr_or_name == lock:
      return True
    return self.cond_alias.get((cls, attr_or_name)) == lock

  def with_held(self, node, fi: astutil.FuncInfo, cls: Optional[str],
                lock: str) -> bool:
    """Is ``node`` structurally inside a with-statement acquiring
    ``lock`` (within the same function)?"""
    n = self.parents.get(node)
    while n is not None and n is not fi.node:
      if isinstance(n, (ast.With, ast.AsyncWith)):
        for item in n.items:
          ce = item.context_expr
          if isinstance(ce, ast.Attribute) and \
              isinstance(ce.value, ast.Name) and ce.value.id == 'self':
            if self._holds(cls, ce.attr, lock):
              return True
          elif isinstance(ce, ast.Name):
            if self._holds(None, ce.id, lock):
              return True
          elif astutil.dotted_name(ce) == lock:
            return True   # another module's lock, by its dotted path
      n = self.parents.get(n)
    return False

  def method_assumes(self, fi: astutil.FuncInfo, lock: str) -> bool:
    f = fi
    while f is not None:   # nested defs inherit the method's assumption
      if self.locked.get(f.qualname) == lock:
        return True
      f = f.parent
    return False


# ---------------------------------------------------------- shared access

def _check_shared(st: _ModState) -> List[Finding]:
  out: List[Finding] = []
  if not st.shared:
    return out
  by_class: Dict[Optional[str], Dict[str, str]] = {}
  for (cls, field), lock in st.shared.items():
    by_class.setdefault(cls, {})[field] = lock

  for fi in st.index.by_qual.values():
    cls = st.class_of(fi.node)
    # the (class-level) method this def belongs to, for the __init__
    # exemption — nested defs inherit their method's status
    parts = fi.qualname.split('.')
    top_method = parts[1] if cls is not None and len(parts) > 1 \
        else parts[0]
    fields = by_class.get(cls, {}) if cls is not None else {}
    globals_ = by_class.get(None, {})
    for node in st.index.own_nodes(fi):
      hit = None   # (display, lock, cls-context)
      if isinstance(node, ast.Attribute) and \
          isinstance(node.value, ast.Name) and node.value.id == 'self' \
          and node.attr in fields:
        hit = (f'self.{node.attr}', fields[node.attr], cls)
      elif isinstance(node, ast.Name) and node.id in globals_:
        hit = (node.id, globals_[node.id], None)
      if hit is None:
        continue
      display, lock, hit_cls = hit
      if top_method == '__init__':
        continue   # construction precedes sharing
      if st.method_assumes(fi, lock):
        continue
      if st.with_held(node, fi, hit_cls, lock):
        continue
      prefix = 'self.' if hit_cls is not None else ''
      out.append(Finding(
          RULE, st.mod.path, st.mod.relpath, node.lineno,
          node.col_offset + 1,
          f"'{display}' is registered shared[{lock}] but is accessed "
          f"outside 'with {prefix}{lock}:' — hold the lock, or mark "
          f"the enclosing method '# graftlint: locked[{lock}]' if "
          'every caller already holds it',
          symbol=fi.qualname))

  # locked[] methods: every intra-class call site must hold the lock
  for qual, lock in st.locked.items():
    if '.' not in qual:
      continue
    cls, mname = qual.split('.', 1)[0], qual.rsplit('.', 1)[-1]
    for fi in st.index.by_qual.values():
      if st.class_of(fi.node) != cls or fi.qualname == qual:
        continue
      if fi.qualname.split('.', 1)[-1].split('.')[0] == '__init__':
        continue
      for node in st.index.own_nodes(fi):
        if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name) and \
            node.func.value.id == 'self' and node.func.attr == mname:
          if st.method_assumes(fi, lock) or \
              st.with_held(node, fi, cls, lock):
            continue
          out.append(Finding(
              RULE, st.mod.path, st.mod.relpath, node.lineno,
              node.col_offset + 1,
              f"'self.{mname}()' assumes {lock} is held "
              f'(locked[{lock}]) but this call site does not hold it',
              symbol=fi.qualname))
  return out


# ------------------------------------------------------------- lock order

def _lock_id(st: _ModState, cls: Optional[str], name: str) -> Optional[str]:
  """Canonical id of the lock acquired by ``with self.<name>:`` (cls
  set) or ``with <name>:`` (module level); Conditions resolve to the
  lock they wrap."""
  wrapped = st.cond_alias.get((cls, name))
  if wrapped is not None:
    name = wrapped
  if cls is not None and name in st.class_locks.get(cls, set()):
    return f'{st.mod.relpath}:{cls}.{name}'
  if name in st.module_locks:
    return f'{st.mod.relpath}:{name}'
  return None


def _with_locks(st: _ModState, node, cls) -> List[str]:
  out = []
  if isinstance(node, (ast.With, ast.AsyncWith)):
    for item in node.items:
      ce = item.context_expr
      if isinstance(ce, ast.Attribute) and \
          isinstance(ce.value, ast.Name) and ce.value.id == 'self':
        lid = _lock_id(st, cls, ce.attr)
      elif isinstance(ce, ast.Name):
        lid = _lock_id(st, None, ce.id)
      else:
        lid = None
      if lid:
        out.append(lid)
  return out


def _resolve_callee(st: _ModState, states_by_mod, call: ast.Call,
                    cls: Optional[str]) -> Optional[Tuple[str, str]]:
  """(module path, qualname) of the called function when resolvable:
  self-method, same-module function, or imported-module function."""
  f = call.func
  if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
    if f.value.id == 'self' and cls is not None:
      qual = f'{cls}.{f.attr}'
      if qual in st.index.by_qual:
        return (st.mod.path, qual)
      return None
    target_mod = st.aliases.get(f.value.id)
    if target_mod:
      suffix = target_mod.replace('.', '/') + '.py'
      for other in states_by_mod.values():
        if other.mod.relpath.endswith(suffix) and \
            f.attr in other.index.by_qual:
          return (other.mod.path, f.attr)
    return None
  if isinstance(f, ast.Name) and f.id in st.index.by_qual:
    return (st.mod.path, f.id)
  return None


def _check_lock_order(states: List[_ModState]) -> List[Finding]:
  states_by_mod = {st.mod.path: st for st in states}
  if not states:
    return []

  # direct acquisitions + resolvable call edges per function
  direct: Dict[Tuple[str, str], Set[str]] = {}
  calls: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
  for st in states:
    for fi in st.index.by_qual.values():
      key = (st.mod.path, fi.qualname)
      cls = st.class_of(fi.node)
      acq: Set[str] = set()
      cs: Set[Tuple[str, str]] = set()
      for node in st.index.own_nodes(fi):
        acq.update(_with_locks(st, node, cls))
        if isinstance(node, ast.Call):
          callee = _resolve_callee(st, states_by_mod, node, cls)
          if callee:
            cs.add(callee)
      lock = st.locked.get(fi.qualname)
      if lock:
        lid = _lock_id(st, cls, lock)
        if lid:
          acq.add(lid)
      direct[key] = acq
      calls[key] = cs

  # transitive closure: locks a call may acquire
  star = {k: set(v) for k, v in direct.items()}
  changed = True
  while changed:
    changed = False
    for k, cs in calls.items():
      for callee in cs:
        extra = star.get(callee, set()) - star[k]
        if extra:
          star[k] |= extra
          changed = True

  # ordering edges: held lock -> lock acquired under it
  edges: Dict[str, Dict[str, Tuple[str, str, int]]] = {}

  def add_edge(a: str, b: str, st: _ModState, line: int):
    if a == b:
      return   # re-entrant self-acquire (RLock) is not an order edge
    edges.setdefault(a, {}).setdefault(
        b, (st.mod.path, st.mod.relpath, line))

  for st in states:
    for fi in st.index.by_qual.values():
      cls = st.class_of(fi.node)
      held_entry: List[Tuple[ast.AST, List[str]]] = []
      lock = st.locked.get(fi.qualname)
      assumed: List[str] = []
      if lock:
        lid = _lock_id(st, cls, lock)
        if lid:
          assumed.append(lid)
      for node in st.index.own_nodes(fi):
        w = _with_locks(st, node, cls)
        if w:
          held_entry.append((node, w))
      # multi-item with: earlier items are held when later ones acquire
      for node, w in held_entry:
        for i, a in enumerate(w):
          for b in w[i + 1:]:
            add_edge(a, b, st, node.lineno)
      # nesting: anything under a with-lock region
      for node, w in held_entry:
        for sub in ast.walk(node):
          if sub is node:
            continue
          if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
          inner = _with_locks(st, sub, cls)
          for a in w:
            for b in inner:
              add_edge(a, b, st, sub.lineno)
          if isinstance(sub, ast.Call):
            callee = _resolve_callee(st, states_by_mod, sub, cls)
            if callee:
              for a in w:
                for b in star.get(callee, ()):
                  add_edge(a, b, st, sub.lineno)
      # locked[] methods: body runs with the assumed lock held
      for a in assumed:
        for node in st.index.own_nodes(fi):
          for b in _with_locks(st, node, cls):
            add_edge(a, b, st, node.lineno)
          if isinstance(node, ast.Call):
            callee = _resolve_callee(st, states_by_mod, node, cls)
            if callee:
              for b in star.get(callee, ()):
                add_edge(a, b, st, node.lineno)

  return _cycle_findings(edges)


def _cycle_findings(edges) -> List[Finding]:
  """One finding per strongly-connected component with >= 2 locks."""
  index_of: Dict[str, int] = {}
  low: Dict[str, int] = {}
  on_stack: Set[str] = set()
  stack: List[str] = []
  sccs: List[List[str]] = []
  counter = [0]

  def strongconnect(v):
    work = [(v, iter(sorted(edges.get(v, {}))))]
    index_of[v] = low[v] = counter[0]
    counter[0] += 1
    stack.append(v)
    on_stack.add(v)
    while work:
      node, it = work[-1]
      advanced = False
      for w in it:
        if w not in index_of:
          index_of[w] = low[w] = counter[0]
          counter[0] += 1
          stack.append(w)
          on_stack.add(w)
          work.append((w, iter(sorted(edges.get(w, {})))))
          advanced = True
          break
        elif w in on_stack:
          low[node] = min(low[node], index_of[w])
      if advanced:
        continue
      work.pop()
      if work:
        low[work[-1][0]] = min(low[work[-1][0]], low[node])
      if low[node] == index_of[node]:
        comp = []
        while True:
          w = stack.pop()
          on_stack.discard(w)
          comp.append(w)
          if w == node:
            break
        sccs.append(comp)

  all_nodes = set(edges)
  for tgts in edges.values():
    all_nodes.update(tgts)
  for v in sorted(all_nodes):
    if v not in index_of:
      strongconnect(v)

  out = []
  for comp in sccs:
    if len(comp) < 2:
      continue
    comp_set = set(comp)
    sites = []
    for a in comp:
      for b, (path, relpath, line) in edges.get(a, {}).items():
        if b in comp_set:
          sites.append((relpath, line, path, a, b))
    sites.sort()
    if not sites:
      continue
    relpath, line, path, _a, _b = sites[0]
    names = ' -> '.join(sorted(c.rsplit(':', 1)[-1] for c in comp))
    out.append(Finding(
        RULE, path, relpath, line, 1,
        f'lock-order cycle between {{{names}}} — these locks are '
        'acquired in conflicting orders on different paths (ABBA '
        'deadlock); pick one global order and hold to it',
        symbol=''))
  return out
