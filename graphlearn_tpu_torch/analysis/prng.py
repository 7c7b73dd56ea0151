"""Rule prng-discipline: counter-addressed keys, never split-and-carry.

The port draws every sampler/loader stream from its threefry module
(``graphlearn_tpu_torch/random.py``, JAX's key layout) so its draws equal
JAX's, and the replay contracts (a restarted worker, a captured chunk,
a resumed epoch) depend on every stream being COUNTER ADDRESSED: step
g's key is ``fold_in(base_key, count0 + g)`` (``ops.step_keys`` on the
card), so any position in the stream is reachable from (base_key,
integer) alone. Split-and-carry (``key, sub = split(key)``) makes
position N reachable only by replaying N splits: a restarted worker or a
captured chunk cannot jump to its offset, and bit-identical replay
silently breaks.

Flags, in sampler/loader-scoped modules (``Config.prng_modules``, the
JAX package's list), over calls that resolve to the port's ``random``
module through the module's imports (``from .. import random as
trandom``, ``from graphlearn_tpu_torch.random import split``, ...):

  * split-and-carry: a ``split`` result assigned back over its own key
    argument (``key, sub = split(key)``, ``self._key, s =
    split(self._key)``).
  * constant-key loops: ``PRNGKey(...)`` created inside a ``for`` /
    ``while`` body, and its torch form, a ``torch.Generator`` made or
    ``manual_seed``-ed inside one: every iteration draws the same
    stream.
  * key reuse: the same key name consumed by two draws (``split``,
    ``random_bits``, ``uniform``, ``randint``, ``permutation``, ...)
    with no intervening reassignment: identical randomness twice.
"""
import ast
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'prng-discipline'

_PKG = 'graphlearn_tpu_torch'
# draws that CONSUME a key (same key twice == same randomness twice);
# fold_in is exempt: fold_in(key, a) / fold_in(key, b) IS the pattern
_CONSUMERS = {'split', 'random_bits', 'uniform', 'randint', 'permutation'}


def check_package(modules: List[ParsedModule], config: Config):
  findings = []
  for mod in modules:
    if not in_scope(mod.relpath, config.prng_modules):
      continue
    findings.extend(_check_module(mod))
  return findings


def random_imports(tree: ast.AST) -> Tuple[Set[str], Set[str],
                                           Dict[str, str]]:
  """(aliases of the port's random module, aliases of the port package,
  {bare name: random function}) from this module's imports. The stdlib
  ``random`` never resolves here: only a relative import or one naming
  the package does."""
  mods: Set[str] = set()
  pkgs: Set[str] = set()
  fns: Dict[str, str] = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if a.name == f'{_PKG}.random' and a.asname:
          mods.add(a.asname)
        elif a.name == _PKG:
          pkgs.add(a.asname or a.name)
        elif a.name == f'{_PKG}.random':
          pkgs.add(_PKG)
    elif isinstance(node, ast.ImportFrom):
      module = node.module or ''
      ours = node.level > 0 or module == _PKG or \
          module.startswith(_PKG + '.')
      if not ours:
        continue
      tail = module.rsplit('.', 1)[-1] if module else ''
      for a in node.names:
        if a.name == 'random' and (not module or module == _PKG):
          mods.add(a.asname or a.name)
        elif tail == 'random' and (node.level > 0 or
                                   module == f'{_PKG}.random'):
          fns[a.asname or a.name] = a.name
  return mods, pkgs, fns


def _random_fn(call: ast.Call, imports) -> Optional[str]:
  """The port random function this call resolves to, or None."""
  mods, pkgs, fns = imports
  func = call.func
  if isinstance(func, ast.Name):
    return fns.get(func.id)
  name = astutil.dotted_name(func)
  if not name or '.' not in name:
    return None
  head, attr = name.rsplit('.', 1)
  if head in mods:
    return attr
  if '.' in head:
    pkg, sub = head.rsplit('.', 1)
    if sub == 'random' and pkg in pkgs:
      return attr
  return None


def _key_expr(node: ast.AST) -> str:
  """Comparable identity for a key expression: bare name or self.attr."""
  if isinstance(node, ast.Name):
    return node.id
  name = astutil.dotted_name(node)
  return name or ''


def _is_generator_seed(call: ast.Call, aliases) -> Optional[str]:
  """'torch.Generator' / 'manual_seed' when the call makes or seeds a
  torch generator, else None."""
  cname = astutil.canonical(astutil.call_name(call), aliases) or ''
  if cname == 'torch.Generator':
    return 'torch.Generator(...)'
  if isinstance(call.func, ast.Attribute) and \
      call.func.attr == 'manual_seed':
    return '.manual_seed(...)'
  return None


def _check_module(mod: ParsedModule) -> List[Finding]:
  out: List[Finding] = []
  index = astutil.index_of(mod)
  aliases = astutil.aliases_of(mod)
  imports = random_imports(mod.tree)

  # ---- split-and-carry ------------------------------------------------
  for node in ast.walk(mod.tree):
    if not isinstance(node, ast.Assign):
      continue
    call = node.value
    if not (isinstance(call, ast.Call) and
            _random_fn(call, imports) == 'split' and call.args):
      continue
    key_id = _key_expr(call.args[0])
    if not key_id:
      continue
    targets = []
    for t in node.targets:
      targets.extend(t.elts if isinstance(t, ast.Tuple) else [t])
    for t in targets:
      if _key_expr(t) == key_id:
        out.append(Finding(
            RULE, mod.path, mod.relpath, node.lineno, node.col_offset + 1,
            f'split-and-carry: random.split({key_id}) assigned back '
            f'over {key_id} — stream position N is then only reachable '
            'by N sequential splits, which breaks chunk replay and '
            'worker-restart fast-forward. Use the counter pattern: '
            'fold_in(base_key, count) per call (sharded: '
            'split(fold_in(base, count), P))'))
        break

  # ---- a constant key inside a loop -------------------------------------
  seen = set()
  for node in ast.walk(mod.tree):
    if not isinstance(node, (ast.For, ast.While)):
      continue
    for sub in ast.walk(node):
      if not isinstance(sub, ast.Call) or id(sub) in seen:
        continue
      if isinstance(sub.func, ast.Attribute) and \
          sub.func.attr == 'manual_seed':
        seen.add(id(sub.func.value))   # one finding per seeded generator
      what = ('random.PRNGKey(...)'
              if _random_fn(sub, imports) == 'PRNGKey'
              else _is_generator_seed(sub, aliases))
      if what is None:
        continue
      seen.add(id(sub))
      out.append(Finding(
          RULE, mod.path, mod.relpath, sub.lineno, sub.col_offset + 1,
          f'{what} constructed inside a loop — unless the seed varies '
          'per iteration this redraws one stream; hoist the base key '
          'and fold_in the loop counter'))

  # ---- key reuse (per function, lexical) -------------------------------
  for fi in index.by_qual.values():
    uses = {}      # key name -> [linenos of consuming draws]
    assigns = {}   # key name -> [linenos of reassignment]
    for node in index.own_nodes(fi):
      if isinstance(node, ast.Call):
        fn = _random_fn(node, imports)
        if fn in _CONSUMERS and node.args and \
            isinstance(node.args[0], ast.Name):
          uses.setdefault(node.args[0].id, []).append(node.lineno)
      for tgt in _assigned_names(node):
        assigns.setdefault(tgt, []).append(node.lineno)
    for key, lines in uses.items():
      lines.sort()
      re_lines = sorted(assigns.get(key, []))
      for a, b in zip(lines, lines[1:]):
        if not any(a < r <= b for r in re_lines):
          out.append(Finding(
              RULE, mod.path, mod.relpath, b, 1,
              f'key reuse: {key!r} is consumed by two random draws '
              f'(lines {a} and {b}) with no reassignment between them — '
              'identical randomness twice; derive one key per draw '
              '(fold_in or split)', symbol=fi.qualname))
  return out


def _assigned_names(node: ast.AST):
  if isinstance(node, ast.Assign):
    for t in node.targets:
      for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
        if isinstance(e, ast.Name):
          yield e.id
  elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
    if isinstance(node.target, ast.Name):
      yield node.target.id
  elif isinstance(node, ast.For):
    t = node.target
    for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
      if isinstance(e, ast.Name):
        yield e.id
