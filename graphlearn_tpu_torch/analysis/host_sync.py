"""Rule host-sync: no implicit device->host round-trips in captured code.

The captured chunks keep a whole chunk of steps on the card as one CUDA
graph replay; ONE stray ``.item()`` / ``int(tensor)`` / ``.cpu()``
inside a function reachable from a captured step body either breaks the
capture (the lucky case) or, on the eager warm-up, the CPU and every
non-capturing trainer, silently reintroduces the per-step host sync the
design removed (ROADMAP hazard H2). An allocation whose size depends on
the data (``nonzero``, ``torch.unique``, ``masked_select``,
``repeat_interleave`` without ``output_size``) syncs the same way: the
host must read the size before it can allocate. This rule flags that
sync surface inside traced functions (``astutil.traced_functions``) and
``with torch.cuda.graph(...)`` bodies of the hot modules
(``Config.hot_sync_modules``, the JAX package's list).

What counts as a sync:

  ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` /
  ``x.to('cpu')`` / ``x.synchronize()`` (a stream or an event)
  ``int(x)`` / ``float(x)`` / ``bool(x)`` on a non-constant argument
  ``torch.cuda.synchronize()`` / ``np.asarray(x)`` / ``np.array(x)``
  ``nonzero`` / ``argwhere`` / ``unique`` / ``masked_select`` (function
  or method form) and ``repeat_interleave`` without ``output_size=``

A call inside ``with strict.explicit():`` (``utils/strict.py``) is a
deliberate sync, the counterpart of JAX's explicit ``device_get``, and
is not flagged. Static host arithmetic on real Python values (a shape,
a config int) is legitimate: suppress those with
``# graftlint: allow[host-sync] <why>``.
"""
import ast
from typing import List

from . import astutil
from .core import Config, Finding, ParsedModule, in_scope

RULE = 'host-sync'

_ATTR_SYNCS = {'item', 'tolist', 'cpu', 'numpy', 'synchronize'}
_CAST_SYNCS = {'int', 'float', 'bool'}
_FUNC_SYNCS = {'numpy.asarray', 'numpy.array', 'torch.cuda.synchronize'}
# allocations sized by the data: function (torch.<name>) or method form
_DYNAMIC_ALLOCS = {'nonzero', 'unique', 'masked_select', 'argwhere'}
_EXPLICIT = ('strict.explicit',)


def _is_const(node: ast.AST) -> bool:
  return isinstance(node, ast.Constant)


def check_package(modules: List[ParsedModule], config: Config):
  findings = []
  for mod in modules:
    if not in_scope(mod.relpath, config.hot_sync_modules):
      continue
    findings.extend(_check_module(mod, config))
  return findings


def _check_module(mod: ParsedModule, config: Config) -> List[Finding]:
  index = astutil.index_of(mod)
  aliases = astutil.aliases_of(mod)
  traced = astutil.traced_functions(index, mod.tree, aliases,
                                    config.traced_step_functions)
  parents = astutil.parents_of(mod)
  regions = []   # (nodes, symbol)
  for qual in sorted(traced):
    fi = index.by_qual.get(qual)
    if fi is not None:
      regions.append((index.own_nodes(fi), qual))
  for block in astutil.graph_blocks(mod.tree, aliases):
    owner = astutil.enclosing_function(index, block, parents)
    if owner is not None and owner.qualname in traced:
      continue   # already walked with its function
    nodes = [n for stmt in block.body
             for n in [stmt, *astutil.own_nodes(stmt)]]
    regions.append((nodes, owner.qualname if owner else ''))
  out: List[Finding] = []
  seen = set()
  for nodes, qual in regions:
    for node in nodes:
      if not isinstance(node, ast.Call) or id(node) in seen:
        continue
      seen.add(id(node))
      msg = _sync_message(node, aliases)
      if not msg or _in_explicit(node, parents, aliases):
        continue
      out.append(Finding(
          RULE, mod.path, mod.relpath, node.lineno, node.col_offset + 1,
          f'{msg} inside captured code — this forces a device->host '
          'sync in a captured/chunked hot path (and breaks a CUDA graph '
          'capture); keep the value on the device, hoist the host step '
          'out of the step, or mark a deliberate sync with '
          'strict.explicit()', symbol=qual))
  return out


def _in_explicit(node, parents, aliases) -> bool:
  """Is ``node`` inside a ``with strict.explicit():`` body (within its
  own function)?"""
  n = parents.get(node)
  while n is not None and not isinstance(
      n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
    if isinstance(n, (ast.With, ast.AsyncWith)):
      for item in n.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call) and astutil.matches(
            astutil.canonical(astutil.call_name(ce), aliases), _EXPLICIT):
          return True
    n = parents.get(n)
  return False


def _to_cpu(call: ast.Call) -> bool:
  """``x.to('cpu')`` / ``x.to(device='cpu')`` / ``x.to(torch.device(
  'cpu'))``."""
  vals = list(call.args[:1]) + [k.value for k in call.keywords
                                if k.arg == 'device']
  for v in vals:
    if isinstance(v, ast.Call) and \
        astutil.last_segment(astutil.call_name(v)) == 'device' and v.args:
      v = v.args[0]
    if isinstance(v, ast.Constant) and isinstance(v.value, str) and \
        v.value.split(':')[0] == 'cpu':
      return True
  return False


def _sync_message(call: ast.Call, aliases) -> str:
  func = call.func
  name = astutil.call_name(call)
  cname = astutil.canonical(name, aliases)
  # EXACT canonical match for the module functions: torch.cuda.synchronize
  # and numpy's asarray/array (torch.asarray is device-side)
  if cname in _FUNC_SYNCS:
    return f'{name}() call'
  if isinstance(func, ast.Attribute):
    if func.attr in _ATTR_SYNCS:
      return f'.{func.attr}() call'
    if func.attr == 'to' and _to_cpu(call):
      return ".to('cpu') call"
    if func.attr in _DYNAMIC_ALLOCS:
      return f'{func.attr}() (an allocation sized by the data)'
    if func.attr == 'repeat_interleave' and \
        not any(k.arg == 'output_size' for k in call.keywords):
      return ('repeat_interleave() without output_size (an allocation '
              'sized by the data)')
    return ''
  if isinstance(func, ast.Name):
    if func.id in _CAST_SYNCS:
      if call.args and not all(_is_const(a) for a in call.args):
        return f'{func.id}() cast'
      return ''
    seg = astutil.last_segment(cname)
    if cname and cname.startswith('torch.') and seg in _DYNAMIC_ALLOCS:
      return f'{seg}() (an allocation sized by the data)'
  return ''
