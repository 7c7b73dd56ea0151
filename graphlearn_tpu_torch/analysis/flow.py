"""Flow-aware analysis core: per-function CFGs + forward dataflow.

The port's copy of ``graphlearn_tpu/analysis/flow.py``, line for line
below this docstring (``tests/test_torch_flow_rules.py`` holds the two
CFGs equal). Per-statement AST matching answers "does this call appear
here"; the bracket and lock bug classes are PATH questions ("does every
outgoing edge, including the exception edge out of the prologue, close
this span"). This module gives the rules the machinery to ask them:

* :class:`CFG`: a lightweight statement-level control-flow graph per
  function. Compound statements are decomposed (``if``/loops/``try``/
  ``with``); every statement that can raise carries an EXCEPTION edge
  to the innermost handler/finally region (or straight to EXIT), so
  "provably closed on every outgoing edge" is a reachability question,
  not a lexical one.
* :func:`forward`: a worklist forward dataflow solver over a CFG with
  set-union merge (may-analysis). Rules supply a transfer function
  from (statement, in-state) to out-state, and optionally a separate
  exception-edge transfer, for facts a statement only establishes when
  it COMPLETES (a span token is not held if ``spans.begin`` itself
  raised).
* read/write helpers (:func:`stmt_reads`, :func:`stmt_writes`) that
  treat ``self.<attr>`` as a trackable dotted name.

Pure stdlib ``ast``; best-effort and quiet-on-failure. The CFG
deliberately OVER-approximates paths (a ``finally`` region exits to
both its normal successor and the enclosing exception target; an early
``return`` routes through the innermost finally whose spurious
fall-through continues past the try): for the may-analyses built on it,
extra paths make a rule more cautious on genuinely bracketed code,
never silently blind on unbracketed code.
"""
import ast
from typing import Callable, Dict, FrozenSet, List, Optional, Set

# synthetic node ids
EXIT = 0
ENTRY = 1


class CFG:
  """Statement-level control-flow graph of one function body.

  Nodes are integers; ``stmt_of[n]`` maps a node to its ast statement
  (ENTRY/EXIT have none; several nodes may share one compound
  statement's header). ``succ[n]`` holds normal-flow successors and
  ``exc[n]`` the exception-edge successors — kept separate so a rule
  can flow a different state along "this statement raised midway".
  """

  def __init__(self):
    self.succ: Dict[int, Set[int]] = {EXIT: set(), ENTRY: set()}
    self.exc: Dict[int, Set[int]] = {EXIT: set(), ENTRY: set()}
    self.stmt_of: Dict[int, ast.stmt] = {}
    self._next_id = 2

  def _new(self, stmt: Optional[ast.stmt]) -> int:
    n = self._next_id
    self._next_id += 1
    self.succ[n] = set()
    self.exc[n] = set()
    if stmt is not None:
      self.stmt_of[n] = stmt
    return n

  def _edge(self, a: int, b: int, exc: bool = False):
    (self.exc if exc else self.succ)[a].add(b)

  def nodes(self):
    return self.succ.keys()


def _can_raise(stmt: ast.stmt) -> bool:
  """Conservative: anything containing a call, subscript, attribute
  LOAD, raise, assert, await/yield, or binary op may raise. Plain
  ``pass``, constant/name copies and attribute STORES (``self.x = y``
  on ordinary objects) cannot."""
  if isinstance(stmt, (ast.Raise, ast.Assert)):
    return True
  for node in ast.walk(stmt):
    if isinstance(node, (ast.Call, ast.Subscript, ast.BinOp,
                         ast.Await, ast.Yield, ast.YieldFrom)):
      return True
    if isinstance(node, ast.Attribute) and \
        not isinstance(node.ctx, ast.Store):
      return True
  return False


class _Ctx:
  """Builder context: where control goes on break/continue/raise, and
  the stack of enclosing finally entries an early exit must run."""
  __slots__ = ('break_to', 'continue_to', 'exc_to', 'finally_to')

  def __init__(self, break_to, continue_to, exc_to, finally_to):
    self.break_to: Optional[int] = break_to
    self.continue_to: Optional[int] = continue_to
    self.exc_to = exc_to          # Tuple[int, ...]: exception targets
    self.finally_to = finally_to  # Tuple[int, ...]: outermost..innermost


def build_cfg(fn: ast.AST) -> CFG:
  """CFG of ``fn``'s body (FunctionDef / AsyncFunctionDef). Nested
  function and class definitions are opaque single nodes — their bodies
  do not execute at definition time."""
  cfg = CFG()
  ctx = _Ctx(None, None, (EXIT,), ())
  entry = _build_seq(cfg, fn.body, ctx, EXIT)
  cfg._edge(ENTRY, entry)
  return cfg


def _build_seq(cfg: CFG, stmts: List[ast.stmt], ctx: _Ctx, nxt: int) -> int:
  """Build ``stmts`` so the last falls through to ``nxt``; returns the
  entry node id (``nxt`` itself for an empty sequence)."""
  entry = nxt
  for stmt in reversed(stmts):
    entry = _build_stmt(cfg, stmt, ctx, entry)
  return entry


def _build_stmt(cfg: CFG, stmt: ast.stmt, ctx: _Ctx, nxt: int) -> int:
  if isinstance(stmt, ast.If):
    n = cfg._new(stmt)
    cfg._edge(n, _build_seq(cfg, stmt.body, ctx, nxt))
    cfg._edge(n, _build_seq(cfg, stmt.orelse, ctx, nxt))
    _exc_edges(cfg, n, stmt, ctx)
    return n

  if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
    n = cfg._new(stmt)           # header: test / iterator step
    after = _build_seq(cfg, stmt.orelse, ctx, nxt)
    loop_ctx = _Ctx(nxt, n, ctx.exc_to, ctx.finally_to)
    body = _build_seq(cfg, stmt.body, loop_ctx, n)  # back edge via header
    cfg._edge(n, body)
    cfg._edge(n, after)
    _exc_edges(cfg, n, stmt, ctx)
    return n

  if isinstance(stmt, (ast.With, ast.AsyncWith)):
    # the header evaluates+enters the context managers; the body runs
    # under them. __exit__ re-raises by default, so body exception
    # edges keep the enclosing targets. Rules that care about the
    # managed resources inspect the With node directly.
    n = cfg._new(stmt)
    cfg._edge(n, _build_seq(cfg, stmt.body, ctx, nxt))
    _exc_edges(cfg, n, stmt, ctx)
    return n

  if isinstance(stmt, ast.Try):
    return _build_try(cfg, stmt, ctx, nxt)

  if isinstance(stmt, ast.Return):
    n = cfg._new(stmt)
    # a return runs the innermost enclosing finally, whose own exits
    # carry on; only with no finally does it reach EXIT directly
    cfg._edge(n, ctx.finally_to[-1] if ctx.finally_to else EXIT)
    _exc_edges(cfg, n, stmt, ctx)
    return n

  if isinstance(stmt, ast.Raise):
    n = cfg._new(stmt)
    for t in ctx.exc_to:
      cfg._edge(n, t)
    return n

  if isinstance(stmt, (ast.Break, ast.Continue)):
    n = cfg._new(stmt)
    if ctx.finally_to:
      cfg._edge(n, ctx.finally_to[-1])
    else:
      target = ctx.break_to if isinstance(stmt, ast.Break) \
          else ctx.continue_to
      cfg._edge(n, target if target is not None else EXIT)
    return n

  # simple statement (incl. nested def/class as opaque nodes)
  n = cfg._new(stmt)
  cfg._edge(n, nxt)
  _exc_edges(cfg, n, stmt, ctx)
  return n


def _exc_edges(cfg: CFG, n: int, stmt: ast.stmt, ctx: _Ctx):
  if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
    return
  if _can_raise(stmt):
    for t in ctx.exc_to:
      cfg._edge(n, t, exc=True)


def _build_try(cfg: CFG, stmt: ast.Try, ctx: _Ctx, nxt: int) -> int:
  # finally region: entered on normal completion, from handlers, on
  # unmatched exceptions, and by early exits. It exits to BOTH the
  # normal successor and the enclosing exception targets (the
  # over-approximation the module docstring describes).
  f_entry: Optional[int] = None
  if stmt.finalbody:
    f_entry = _build_seq(cfg, stmt.finalbody, ctx, nxt)
    for node in list(cfg.succ):
      if node in (EXIT, ENTRY):
        continue
      if nxt in cfg.succ[node] and _in_region(cfg, node, stmt.finalbody):
        for t in ctx.exc_to:
          cfg._edge(node, t)

  after_body = f_entry if f_entry is not None else nxt
  inner_finally = ctx.finally_to + ((f_entry,) if f_entry is not None
                                    else ())

  # handler bodies: exceptions raised INSIDE a handler go to the
  # finally (if any) or the enclosing targets, never back to a sibling
  handler_ctx = _Ctx(ctx.break_to, ctx.continue_to,
                     (f_entry,) if f_entry is not None else ctx.exc_to,
                     inner_finally)
  exc_targets: List[int] = []
  for h in stmt.handlers:
    exc_targets.append(_build_seq(cfg, h.body, handler_ctx, after_body))
  if f_entry is not None:
    exc_targets.append(f_entry)   # unmatched exception: finally runs
  if not exc_targets:
    exc_targets = list(ctx.exc_to)

  body_ctx = _Ctx(ctx.break_to, ctx.continue_to, tuple(exc_targets),
                  inner_finally)
  orelse = _build_seq(cfg, stmt.orelse, body_ctx, after_body)
  return _build_seq(cfg, stmt.body, body_ctx, orelse)


def _in_region(cfg: CFG, node: int, stmts: List[ast.stmt]) -> bool:
  s = cfg.stmt_of.get(node)
  if s is None:
    return False
  for top in stmts:
    if s is top:
      return True
    for sub in ast.walk(top):
      if sub is s:
        return True
  return False


# ---------------------------------------------------------------- dataflow

State = FrozenSet[str]
Transfer = Callable[[int, Optional[ast.stmt], State], State]


def forward(cfg: CFG, init: State, transfer: Transfer,
            exc_transfer: Optional[Transfer] = None) -> Dict[int, State]:
  """Worklist forward may-analysis: returns the IN-state of every node
  (union over predecessors' out-states). ``transfer(node_id, stmt,
  in_state)`` produces a node's normal out-state; ``exc_transfer``
  (default: same as ``transfer``) produces the state flowing along its
  exception edges. ENTRY's in-state is ``init``."""
  flow_preds: Dict[int, List[int]] = {n: [] for n in cfg.nodes()}
  exc_preds: Dict[int, List[int]] = {n: [] for n in cfg.nodes()}
  for a in cfg.nodes():
    for b in cfg.succ[a]:
      flow_preds[b].append(a)
    for b in cfg.exc[a]:
      exc_preds[b].append(a)

  in_s: Dict[int, State] = {n: frozenset() for n in cfg.nodes()}
  out_s: Dict[int, State] = dict(in_s)
  exc_out_s: Dict[int, State] = dict(in_s)

  def apply(n: int, state: State):
    stmt = cfg.stmt_of.get(n)
    out = transfer(n, stmt, state)
    exc_out = exc_transfer(n, stmt, state) if exc_transfer else out
    return out, exc_out

  in_s[ENTRY] = init
  out_s[ENTRY], exc_out_s[ENTRY] = apply(ENTRY, init)
  work = sorted(n for n in cfg.nodes() if n != ENTRY)
  # gen/kill transfers over a finite name lattice are monotone; the cap
  # is a parse-bomb guard, not a correctness device
  cap = 200 * (len(in_s) + 2)
  while work and cap > 0:
    cap -= 1
    n = work.pop(0)
    pieces = [out_s[p] for p in flow_preds[n]] + \
        [exc_out_s[p] for p in exc_preds[n]]
    new_in = frozenset().union(*pieces) if pieces else frozenset()
    if n == ENTRY:
      new_in |= init
    new_out, new_exc = apply(n, new_in)
    if new_in == in_s[n] and new_out == out_s[n] and \
        new_exc == exc_out_s[n]:
      continue
    in_s[n], out_s[n], exc_out_s[n] = new_in, new_out, new_exc
    for b in cfg.succ[n] | cfg.exc[n]:
      if b not in work:
        work.append(b)
  return in_s


# ----------------------------------------------------------- reads / writes

def dotted(node: ast.AST) -> Optional[str]:
  """'self._emb' for a one-level attribute, 'x' for a bare name. Deeper
  chains (a.b.c) return None — the rules track locals and self-fields,
  nothing fancier."""
  if isinstance(node, ast.Name):
    return node.id
  if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
    return f'{node.value.id}.{node.attr}'
  return None


def expr_reads(expr: ast.AST) -> Set[str]:
  """Trackable names loaded anywhere inside ``expr``: bare locals plus
  one-level dotted reads (``self._emb``, ``obj.attr``). An attribute
  read also reports its base — reading ``state.params`` reads
  ``state``."""
  out: Set[str] = set()
  for node in ast.walk(expr):
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
      out.add(node.id)
    elif isinstance(node, ast.Attribute) and \
        isinstance(node.ctx, ast.Load):
      d = dotted(node)
      if d:
        out.add(d)
  return out


def stmt_reads(stmt: ast.stmt) -> Set[str]:
  """Names the statement reads. For assignments, the RHS plus any
  subscript indices/containers on the LHS; for compound headers, the
  test/iterator/items expression only (bodies are separate nodes)."""
  if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
    out = expr_reads(stmt.value) if stmt.value is not None else set()
    if isinstance(stmt, ast.AugAssign):
      d = dotted(stmt.target)
      if d:
        out.add(d)
    targets = stmt.targets if isinstance(stmt, ast.Assign) \
        else [stmt.target]
    for t in targets:
      for sub in ast.walk(t):
        if isinstance(sub, ast.Subscript):
          out |= expr_reads(sub.slice)
          d = dotted(sub.value)
          if d:
            out.add(d)   # x[i] = v reads (the container identity of) x
    return out
  if isinstance(stmt, (ast.If, ast.While)):
    return expr_reads(stmt.test)
  if isinstance(stmt, (ast.For, ast.AsyncFor)):
    return expr_reads(stmt.iter)
  if isinstance(stmt, (ast.With, ast.AsyncWith)):
    out = set()
    for item in stmt.items:
      out |= expr_reads(item.context_expr)
    return out
  if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
    return set()
  out = set()
  for child in ast.iter_child_nodes(stmt):
    out |= expr_reads(child)
  return out


def stmt_writes(stmt: ast.stmt) -> Set[str]:
  """Trackable names the statement (re)binds: assignment targets and
  loop/with targets — bare names and ``self.<attr>``. Subscript stores
  (``x[i] = v``) mutate, they do not rebind, so they are excluded."""
  out: Set[str] = set()

  def targets_of(t):
    if isinstance(t, (ast.Tuple, ast.List)):
      for e in t.elts:
        targets_of(e)
    elif not isinstance(t, (ast.Subscript, ast.Starred)):
      d = dotted(t)
      if d:
        out.add(d)

  if isinstance(stmt, ast.Assign):
    for t in stmt.targets:
      targets_of(t)
  elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
    targets_of(stmt.target)
  elif isinstance(stmt, (ast.For, ast.AsyncFor)):
    targets_of(stmt.target)
  elif isinstance(stmt, (ast.With, ast.AsyncWith)):
    for item in stmt.items:
      if item.optional_vars is not None:
        targets_of(item.optional_vars)
  return out


def stmt_calls(stmt: ast.stmt) -> List[ast.Call]:
  """Call nodes appearing in this statement (header expressions only
  for compounds; lambdas and nested defs are opaque)."""
  if isinstance(stmt, (ast.If, ast.While)):
    roots: List[ast.AST] = [stmt.test]
  elif isinstance(stmt, (ast.For, ast.AsyncFor)):
    roots = [stmt.iter]
  elif isinstance(stmt, (ast.With, ast.AsyncWith)):
    roots = [i.context_expr for i in stmt.items]
  elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
    return []
  else:
    roots = [stmt]
  out: List[ast.Call] = []
  stack: List[ast.AST] = list(roots)
  while stack:
    node = stack.pop()
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
      continue
    if isinstance(node, ast.Call):
      out.append(node)
    stack.extend(ast.iter_child_nodes(node))
  return out
