"""The port's flow-aware core (``graphlearn_tpu_torch/analysis/flow.py``)
against the JAX package's, and the port linter's CLI surface.

* :class:`TestCfgParity`: the CFG the port builds for a function equals
  JAX's, node for node and edge for edge (normal and exception edges,
  and which statement each node stands for), and so does a forward
  dataflow over it. The functions are every ``_fn`` snippet of
  ``tests/test_flow_rules.py``, every function of that file itself, and
  every function of three port modules (``loader/scan_epoch.py``,
  ``loader/pipeline.py``, ``distributed/remote_scan.py``).
* :class:`TestFlowCore`: ``tests/test_flow_rules.py``'s unit tests of
  the CFG shape, the solver and the read/write helpers, on the port's
  module.
* :class:`TestJaxOnlyCorpus`: the regression fixtures of the JAX-only
  rules (donation, retrace) are silent in the port, which has neither
  rule.
* :class:`TestCliV2`: ``--format json`` (per-rule timings included),
  ``--timings``, ``--profile bench`` and ``--changed-only`` inside a git
  repository (filters to touched files) and outside one (reports
  everything, loudly).
"""
import ast
import json
import os
import subprocess
import textwrap

import pytest
import torch

from graphlearn_tpu.analysis import flow as jflow
from graphlearn_tpu_torch.analysis import flow
from graphlearn_tpu_torch.analysis.core import Config, run_lint
from graphlearn_tpu_torch.analysis.flow import (ENTRY, EXIT, build_cfg,
                                                forward)
from graphlearn_tpu_torch.analysis.lint import main as lint_main

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'graphlearn_tpu_torch')
CORPUS = os.path.join(REPO, 'tests', 'fixtures_graftlint')
JAX_FLOW_TESTS = os.path.join(REPO, 'tests', 'test_flow_rules.py')
PORT_MODULES = ('loader/scan_epoch.py', 'loader/pipeline.py',
                'distributed/remote_scan.py')


def _fn(source: str) -> ast.FunctionDef:
  tree = ast.parse(textwrap.dedent(source))
  node = tree.body[0]
  assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
  return node


def _reachable(cfg, start: int):
  seen, stack = set(), [start]
  while stack:
    n = stack.pop()
    if n in seen:
      continue
    seen.add(n)
    stack.extend(cfg.succ[n] | cfg.exc[n])
  return seen


# ------------------------------------------------------------ CFG parity

def _functions(tree):
  return [n for n in ast.walk(tree)
          if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _snippet_functions():
  """The functions the JAX flow tests build CFGs of (their ``_fn``
  snippets), and the test file's own functions."""
  tree = ast.parse(open(JAX_FLOW_TESTS).read())
  out = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Name) and node.func.id == '_fn' and \
        node.args and isinstance(node.args[0], ast.Constant):
      out.append(_fn(node.args[0].value))
  assert len(out) >= 7
  return out + _functions(tree)


def _port_functions(rel):
  return _functions(ast.parse(open(os.path.join(PKG, rel)).read()))


def _cfg_shape(mod, fn):
  cfg = mod.build_cfg(fn)
  return ({n: sorted(s) for n, s in cfg.succ.items()},
          {n: sorted(s) for n, s in cfg.exc.items()},
          {n: id(s) for n, s in cfg.stmt_of.items()}, cfg)


def _writes_flow(mod, cfg):
  """A forward may-analysis both modules run: the names written so far,
  with an exception transfer that forgets the raising statement's."""
  def transfer(n, stmt, state):
    return state | frozenset(mod.stmt_writes(stmt)) if stmt is not None \
        else state

  def exc_transfer(n, stmt, state):
    return state

  return mod.forward(cfg, frozenset(), transfer, exc_transfer)


def _assert_same_cfgs(fns):
  for fn in fns:
    js, je, jstmt, jcfg = _cfg_shape(jflow, fn)
    ts, te, tstmt, tcfg = _cfg_shape(flow, fn)
    assert (ts, te, tstmt) == (js, je, jstmt), fn.name
    assert _writes_flow(flow, tcfg) == _writes_flow(jflow, jcfg), fn.name
    for stmt in ast.walk(fn):
      if isinstance(stmt, ast.stmt):
        assert flow.stmt_reads(stmt) == jflow.stmt_reads(stmt)
        assert flow.stmt_writes(stmt) == jflow.stmt_writes(stmt)
        assert [id(c) for c in flow.stmt_calls(stmt)] == \
            [id(c) for c in jflow.stmt_calls(stmt)]


class TestCfgParity:

  def test_the_jax_flow_tests_functions(self):
    _assert_same_cfgs(_snippet_functions())

  @pytest.mark.parametrize('rel', PORT_MODULES)
  def test_every_function_of_a_port_module(self, rel):
    fns = _port_functions(rel)
    assert len(fns) >= 20
    _assert_same_cfgs(fns)

  def test_the_copy_is_jaxs_below_its_docstring(self):
    """flow.py is a straight copy: everything after the module docstring
    is JAX's, byte for byte."""
    def body(path):
      src = open(path).read()
      return src[src.index('\nimport ast'):]
    assert body(flow.__file__) == body(jflow.__file__)


# ------------------------------------------------------------- flow core

class TestFlowCore:

  def test_linear_chain_reaches_exit(self):
    cfg = build_cfg(_fn('''
        def f(x):
            a = x + 1
            b = a + 2
            return b
        '''))
    assert EXIT in _reachable(cfg, ENTRY)
    assert len(cfg.stmt_of) == 3

  def test_if_has_both_arms_and_join(self):
    cfg = build_cfg(_fn('''
        def f(x):
            if x:
                a = 1
            else:
                a = 2
            return a
        '''))
    ret = [n for n, s in cfg.stmt_of.items() if isinstance(s, ast.Return)]
    assigns = [n for n, s in cfg.stmt_of.items()
               if isinstance(s, ast.Assign)]
    assert len(ret) == 1 and len(assigns) == 2
    for n in assigns:
      assert ret[0] in _reachable(cfg, n)

  def test_call_statement_carries_exception_edge(self):
    cfg = build_cfg(_fn('''
        def f(x):
            y = g(x)
            return y
        '''))
    call = [n for n, s in cfg.stmt_of.items()
            if isinstance(s, ast.Assign)][0]
    assert EXIT in cfg.exc[call]

  def test_plain_self_store_has_no_exception_edge(self):
    cfg = build_cfg(_fn('''
        def f(self, y):
            self.x = y
            return y
        '''))
    store = [n for n, s in cfg.stmt_of.items()
             if isinstance(s, ast.Assign)][0]
    assert cfg.exc[store] == set()

  def test_return_routes_through_finally(self):
    cfg = build_cfg(_fn('''
        def f(tok):
            try:
                return work(tok)
            finally:
                close(tok)
        '''))
    ret = [n for n, s in cfg.stmt_of.items()
           if isinstance(s, ast.Return)][0]
    fin = [n for n, s in cfg.stmt_of.items()
           if isinstance(s, ast.Expr) and
           isinstance(s.value, ast.Call) and
           flow.dotted(s.value.func) == 'close'][0]
    assert cfg.succ[ret] | cfg.exc[ret] == {fin}

  def test_allocation_before_try_leaks_the_bracket(self):
    """The pipeline's bracket fault: a raising statement between the
    opener and the try reaches EXIT along an exception edge that skips
    the finally."""
    cfg = build_cfg(_fn('''
        def run(self, device):
            tok = flight.epoch_begin()
            ovf = torch.zeros((), device=device)
            try:
                work(ovf)
            finally:
                flight.end_for(self, tok)
        '''))
    alloc = [n for n, s in cfg.stmt_of.items()
             if isinstance(s, ast.Assign) and
             flow.stmt_writes(s) == {'ovf'}][0]
    assert EXIT in cfg.exc[alloc]

  def test_forward_may_analysis_unions_branches(self):
    cfg = build_cfg(_fn('''
        def f(x):
            if x:
                a = 1
            else:
                b = 2
            return x
        '''))

    def transfer(n, stmt, state):
      gen = frozenset(
          flow.stmt_writes(stmt)) if stmt is not None else frozenset()
      return state | gen

    in_s = forward(cfg, frozenset(), transfer)
    assert {'a', 'b'} <= in_s[EXIT]

  def test_forward_exc_transfer_feeds_handler(self):
    cfg = build_cfg(_fn('''
        def f(x):
            try:
                tok = begin()
            except RuntimeError:
                h = 1
            return x
        '''))

    def transfer(n, stmt, state):
      if stmt is not None and 'tok' in flow.stmt_writes(stmt):
        return state | {'tok'}
      return state

    def exc_transfer(n, stmt, state):
      return state

    in_s = forward(cfg, frozenset(), transfer, exc_transfer)
    handler = [n for n, s in cfg.stmt_of.items()
               if isinstance(s, ast.Assign) and
               flow.stmt_writes(s) == {'h'}][0]
    assert 'tok' not in in_s[handler]
    assert 'tok' in in_s[EXIT]

  def test_reads_writes_track_self_fields(self):
    stmt = ast.parse('self._emb = update(self._emb, idx)').body[0]
    assert 'self._emb' in flow.stmt_writes(stmt)
    reads = flow.stmt_reads(stmt)
    assert 'self._emb' in reads and 'idx' in reads
    assert flow.dotted(ast.parse('a.b.c', mode='eval').body) is None


# ------------------------------------------------------ JAX-only fixtures

def _corpus(prefixes):
  return sorted(n for n in os.listdir(CORPUS)
                if n.split('_')[0] in prefixes and n.endswith('.py'))


class TestJaxOnlyCorpus:
  """donation-safety and retrace-hazard are JAX-only: their bug fixtures
  carry nothing the port's rules flag."""

  @pytest.mark.parametrize('name', _corpus(('don', 'ret')))
  def test_silent_in_the_port(self, name):
    found = run_lint([os.path.join(CORPUS, name)], Config()).findings
    assert found == [], '\n'.join(f.render() for f in found)


# --------------------------------------------------------------- CLI v2

class TestCliV2:

  def _bug(self, tmp_path):
    p = tmp_path / 'brk_cli_case.py'
    p.write_text(textwrap.dedent('''
        from graphlearn_tpu_torch.metrics import spans


        def run(n):
          tok = spans.begin('epoch.run')
          out = work(n)
          spans.end(tok)
          return out
        '''))
    return str(p)

  def test_json_format_shape_and_exit(self, tmp_path, capsys):
    rc = lint_main(['--format', 'json', '--no-baseline',
                    self._bug(tmp_path)])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc['files'] == 1 and doc['profile'] == 'default'
    assert not doc['changed_only']
    assert {f['rule'] for f in doc['findings']} == {'bracket-discipline'}
    f = doc['findings'][0]
    assert {'rule', 'path', 'relpath', 'line', 'col', 'message',
            'symbol'} <= set(f)
    assert 'bracket-discipline' in doc['timings_ms']
    assert all(isinstance(v, (int, float))
               for v in doc['timings_ms'].values())

  def test_json_clean_exits_zero(self, tmp_path, capsys):
    p = tmp_path / 'ok.py'
    p.write_text('x = 1\n')
    assert lint_main(['--format', 'json', '--no-baseline', str(p)]) == 0
    assert json.loads(capsys.readouterr().out)['findings'] == []

  def test_timings_flag_prints_per_rule_wall(self, tmp_path, capsys):
    p = tmp_path / 'ok.py'
    p.write_text('x = 1\n')
    assert lint_main(['--timings', '--no-baseline', str(p)]) == 0
    out = capsys.readouterr().out
    assert 'total (rules)' in out and 'ms' in out

  def test_bench_profile_relaxes_scoping_not_brackets(self, tmp_path,
                                                      capsys):
    leak = self._bug(tmp_path)
    assert lint_main(['--profile', 'bench', '--no-baseline', leak]) == 1
    assert 'bracket-discipline' in capsys.readouterr().out
    # a package, so the file's relpath is the hot module's
    (tmp_path / 'pkg' / 'loader').mkdir(parents=True)
    for d in ('pkg', 'pkg/loader'):
      (tmp_path / d / '__init__.py').write_text('')
    sync = tmp_path / 'pkg' / 'loader' / 'scan_epoch.py'
    sync.write_text(textwrap.dedent('''
        class T:
            def _chunk(self, x):
                return x.item()
        '''))
    assert lint_main(['--no-baseline', str(sync)]) == 1
    capsys.readouterr()
    assert lint_main(['--profile', 'bench', '--no-baseline',
                      str(sync)]) == 0

  def test_bench_profile_over_the_ports_benchmarks(self, capsys):
    assert lint_main(['--profile', 'bench', '--format', 'json',
                      os.path.join(PKG, 'benchmarks')]) == 0
    assert json.loads(capsys.readouterr().out)['profile'] == 'bench'

  def test_changed_only_filters_to_touched_files(self, tmp_path, capsys):
    git = ['git', '-c', 'user.email=t@t', '-c', 'user.name=t']
    subprocess.run(['git', 'init', '-q', str(tmp_path)], check=True)
    committed = self._bug(tmp_path)
    subprocess.run(['git', 'add', '.'], cwd=tmp_path, check=True)
    subprocess.run(git + ['commit', '-qm', 'seed'], cwd=tmp_path,
                   check=True)
    fresh = tmp_path / 'brk_untracked_case.py'
    fresh.write_text(open(committed).read().replace(
        'def run', 'def run2'))
    rc = lint_main(['--changed-only', '--no-baseline', str(tmp_path)])
    assert rc == 1
    out = capsys.readouterr().out
    assert 'brk_untracked_case.py' in out
    assert 'brk_cli_case.py' not in out
    assert 'outside --changed-only' in out

  def test_changed_only_outside_git_reports_everything(self, tmp_path,
                                                       capsys,
                                                       monkeypatch):
    monkeypatch.setenv('GIT_DIR', str(tmp_path / 'no-such-repo'))
    rc = lint_main(['--changed-only', '--no-baseline',
                    self._bug(tmp_path)])
    assert rc == 1
    assert 'git unavailable' in capsys.readouterr().err
