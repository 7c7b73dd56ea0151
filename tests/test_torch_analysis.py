"""The port's static analyzer (``graphlearn_tpu_torch/analysis``) against
the JAX package's, its torch rules, and the gate over the port.

* Parity, exact: the same sources go through JAX's ``run_lint`` and the
  port's with configs that point at the same fixtures, and the rendered
  findings (rule, relpath, line, col) are equal, and so are the baseline
  fingerprints; messages differ at most in the doc path they name. The
  sources are ``tests/test_analysis.py``'s snippets of the shared rules
  (fault points, metric and span names, hetero gates, pragmas, the
  baseline round trip, CLI exit codes; the pragma and baseline snippets
  re-cast onto the hetero-gate rule, since JAX's ride its JAX-only
  host-sync rule) and the bracket and lock files of
  ``tests/fixtures_graftlint/``.
* The torch rules as bug/fixed pairs: each of ``host-sync``,
  ``prng-discipline`` and ``dispatch-instrumentation`` catches every bug
  snippet and passes its twin. JAX's PRNG snippets rewritten onto the
  port's ``random`` module give the findings JAX's rule gives on the
  originals. Copies of real port modules under ``tmp_path`` with one
  fault put back (a ``.item()`` in a captured chunk, an unrecorded
  replay, the pipeline's bracket leak, an unlocked launch counter) are
  flagged.
* The gate: the port's linter over ``graphlearn_tpu_torch/`` finds no
  live finding with its (empty) baseline and walks at least 140
  modules, once for the whole file (a module-scoped fixture); no module
  of the analyzer imports jax, torch or either package.

Fixture files live in tmp_path (no package ``__init__``), so their
package-relative path is their basename; Config patterns name them so.
"""
import ast
import json
import os
import re
import textwrap

import pytest
import torch

from graphlearn_tpu.analysis import core as jcore
from graphlearn_tpu.analysis.lint import main as jlint_main
from graphlearn_tpu_torch.analysis import core
from graphlearn_tpu_torch.analysis import lint as tlint
from graphlearn_tpu_torch.analysis.core import Config, run_lint
from graphlearn_tpu_torch.analysis.lint import main as lint_main

# Six pytest workers share eight cores: one intra-op torch thread each.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'graphlearn_tpu_torch')
CORPUS = os.path.join(REPO, 'tests', 'fixtures_graftlint')
ANALYSIS = os.path.join(PKG, 'analysis')

SHARED = {'fault-point-coverage', 'metric-registry', 'span-registry',
          'hetero-gate', 'bracket-discipline', 'lock-discipline',
          'pragma', 'syntax'}


def _write(tmp_path, name, source):
  path = tmp_path / name
  path.write_text(textwrap.dedent(source))
  return str(path)


def _rules(findings):
  return [f.rule for f in findings]


def _norm_message(msg: str) -> str:
  """A message with the doc path it names (and the pragma rule list,
  which names each package's own rules) normalized away."""
  msg = re.sub(r'[\w./]+\.md', '<doc>', msg)
  return msg.split(' — valid rules:')[0]


def _both(paths, **cfg):
  """``{'jax': ..., 'port': ...}`` of (findings in the shared rules,
  their fingerprints, n_pragma, n_base) for the same sources and
  config."""
  paths = [paths] if isinstance(paths, str) else paths
  out = {}
  for name, mod in (('jax', jcore), ('port', core)):
    res = mod.run_lint(paths, mod.Config(**cfg))
    live = [f for f in res.findings if f.rule in SHARED]
    out[name] = (live, mod.fingerprints_for(live, res.modules),
                 res.n_pragma, res.n_base)
  return out


def assert_parity(paths, **cfg):
  """The two linters agree on the shared rules: findings by (rule,
  relpath, line, col), fingerprints, messages up to the doc path and
  the suppression counts. Returns the port's findings."""
  got = _both(paths, **cfg)
  (jf, jfp, jn, jb), (tf, tfp, tn, tb) = got['jax'], got['port']
  key = lambda f: (f.rule, f.relpath, f.line, f.col)  # noqa: E731
  assert [key(f) for f in tf] == [key(f) for f in jf]
  assert tfp == jfp
  assert [_norm_message(f.message) for f in tf] == \
      [_norm_message(f.message) for f in jf]
  assert [f.symbol for f in tf] == [f.symbol for f in jf]
  assert (tn, tb) == (jn, jb)
  return tf


# ------------------------------------------------------ fault-point-coverage

def _registry(tmp_path, names):
  body = ',\n        '.join(f'{n!r}' for n in names)
  return _write(tmp_path, 'faults_fix.py', f'''
      REGISTERED_SITES = frozenset({{
          {body}
      }})
      ''')


def _doc(tmp_path, names):
  doc_dir = tmp_path / 'docs'
  doc_dir.mkdir(exist_ok=True)
  rows = '\n'.join(f'| `{n}` | somewhere | raise |' for n in names)
  (doc_dir / 'failure_model.md').write_text(
      f'# Failure model\n\n| Site | Location | Arming |\n'
      f'| --- | --- | --- |\n{rows}\n')


def _fault_cfg(tmp_path):
  return dict(fault_registry_module='faults_fix.py',
              failure_doc='docs/failure_model.md', repo_root=str(tmp_path))


FAULT_CASES = {
    'clean': (['a.b', 'c.d'], ['a.b', 'c.d'], '''
        from graphlearn_tpu_torch.utils.faults import fault_point

        def f():
            fault_point('a.b')

        def g():
            fault_point('c.d')
        ''', []),
    'unregistered_and_undocumented': (['a.b'], ['a.b'], '''
        from graphlearn_tpu_torch.utils.faults import fault_point

        def f():
            fault_point('a.b')

        def g():
            fault_point('rogue.site')
        ''', ['REGISTERED_SITES', 'not documented']),
    'duplicate': (['a.b'], ['a.b'], '''
        from graphlearn_tpu_torch.utils.faults import fault_point

        def f():
            fault_point('a.b')

        def g():
            fault_point('a.b')
        ''', ['duplicate fault site']),
    'stale': (['a.b', 'ghost.site'], ['a.b', 'ghost.site'], '''
        from graphlearn_tpu_torch.utils.faults import fault_point

        def f():
            fault_point('a.b')
        ''', ['stale registration']),
    'computed': (['a.b'], ['a.b'], '''
        from graphlearn_tpu_torch.utils.faults import fault_point

        def f(which):
            fault_point('site.' + which)
        ''', ['string literal']),
}


@pytest.mark.parametrize('case', sorted(FAULT_CASES))
def test_fault_point_coverage_parity(tmp_path, case):
  registered, documented, src, expect = FAULT_CASES[case]
  reg = _registry(tmp_path, registered)
  _doc(tmp_path, documented)
  sites = _write(tmp_path, 'sites.py', src)
  found = assert_parity([reg, sites], **_fault_cfg(tmp_path))
  assert _rules(found) == ['fault-point-coverage'] * len(expect)
  for want in expect:
    assert any(want in f.message for f in found), (case, want)


# ------------------------------------------------- metric and span names

def _names_registry(tmp_path):
  return _write(tmp_path, 'names_fix.py', '''
      REGISTERED_METRICS = frozenset({
          'a.count',
          'a.ms',
          'fam.*',
          'undoc.count',
      })
      REGISTERED_SPANS = frozenset({
          'a.span',
          'undoc.span',
      })
      ''')


def _names_doc(tmp_path):
  (tmp_path / 'obs.md').write_text(
      '| `a.count` | `a.ms` | `fam.*` | `a.span` |\n')


NAMES_CASES = {
    'clean': ('''
        from graphlearn_tpu_torch import metrics
        from graphlearn_tpu_torch.metrics import spans
        from graphlearn_tpu_torch.utils import trace

        def f(x):
            metrics.inc('a.count')
            metrics.observe('a.ms', 1.0)
            trace.counter_inc(f'fam.{x}')
            with spans.span('a.span'):
                pass
        ''', []),
    'unregistered_computed_undocumented': ('''
        from graphlearn_tpu_torch import metrics
        from graphlearn_tpu_torch.metrics import spans

        def f(x, name):
            metrics.inc('rogue.count')
            metrics.inc(name)
            metrics.inc('a.count' if x else 'a.ms')
            metrics.set_gauge(f'{x}.tail', 1)
            metrics.inc('undoc.count')
            spans.emit('rogue.span')
            tok = spans.begin(name)
            spans.end(tok)
            with spans.span('undoc.span'):
                pass
        ''', ['metric-registry'] * 5 + ['span-registry'] * 3),
}


@pytest.mark.parametrize('case', sorted(NAMES_CASES))
def test_metric_and_span_registry_parity(tmp_path, case):
  src, expect = NAMES_CASES[case]
  reg = _names_registry(tmp_path)
  _names_doc(tmp_path)
  mod = _write(tmp_path, 'emit.py', src)
  found = assert_parity([reg, mod], metrics_registry_module='names_fix.py',
                        observability_doc='obs.md',
                        repo_root=str(tmp_path))
  # the undocumented registry entries are found at the registry too
  at_sites = [f.rule for f in found if f.relpath == 'emit.py']
  assert sorted(at_sites) == sorted(expect)


# -------------------------------------------------------------- hetero-gate

HETERO_CASES = {
    'bare_raise_and_warn': ('''
        import warnings

        def check(self):
            if self.is_hetero:
                raise ValueError('homogeneous-only')

        def check_soft(ds):
            if getattr(ds, 'is_hetero', False):
                warnings.warn('hetero path unvalidated')
        ''', 2, 0),
    'else_branch_raise': ('''
        def check(ds):
            if not ds.is_hetero:
                pass
            else:
                raise NotImplementedError('typed stores unsupported')
        ''', 1, 0),
    'capacity_plan_error': ('''
        from graphlearn_tpu_torch.sampler import CapacityPlanError

        def check(self):
            if self.is_hetero:
                raise CapacityPlanError(
                    'Trainer', 'per-ntype feature stores')
        ''', 0, 0),
    'nested_raise': ('''
        def deep(self, parts):
            if self.is_hetero:
                for part in parts:
                    if part is None:
                        raise ValueError('bad partition input')
        ''', 0, 0),
    'bare_reraise': ('''
        def fwd(self, exc):
            try:
                self._run()
            except Exception:
                if self.is_hetero:
                    raise
        ''', 0, 0),
    'pragma_suppresses': ('''
        def check(self):
            if self.is_hetero:
                # graftlint: allow[hetero-gate] homo accessor by contract
                raise ValueError('homo-only accessor')
        ''', 0, 1),
}


@pytest.mark.parametrize('case', sorted(HETERO_CASES))
def test_hetero_gate_parity(tmp_path, case):
  src, n, n_pragma = HETERO_CASES[case]
  p = _write(tmp_path, 'fix.py', src)
  found = assert_parity(p)
  assert _rules(found) == ['hetero-gate'] * n
  if n:
    assert 'CapacityPlanError' in found[0].message
    assert 'docs/capacity_plans.md' in found[0].message
  assert core.run_lint([p], Config()).n_pragma == n_pragma


# ------------------------------------------------------------------ pragmas

GATE = '''
    def check(self):
        if self.is_hetero:
            raise ValueError('homo-only'){pragma}
    '''

PRAGMA_CASES = {
    'same_line': ('  # graftlint: allow[hetero-gate] homo accessor', [], 1),
    'no_reason': ('  # graftlint: allow[hetero-gate]',
                  ['hetero-gate', 'pragma'], 0),
    'unknown_rule': ('  # graftlint: allow[no-such-rule] because',
                     ['hetero-gate', 'pragma'], 0),
    'wrong_rule': ('  # graftlint: allow[lock-discipline] wrong rule',
                   ['hetero-gate'], 0),
    'malformed': ('  # graftlint: permit everything', ['hetero-gate',
                                                      'pragma'], 0),
    'annotation_without_lock': ('  # graftlint: shared[]',
                                ['hetero-gate', 'pragma'], 0),
}


@pytest.mark.parametrize('case', sorted(PRAGMA_CASES))
def test_pragma_parity(tmp_path, case):
  pragma, expect, n_pragma = PRAGMA_CASES[case]
  p = _write(tmp_path, 'fix.py', GATE.format(pragma=pragma))
  found = assert_parity(p)
  assert sorted(_rules(found)) == expect
  assert core.run_lint([p], Config()).n_pragma == n_pragma


def test_line_above_pragma_and_docstring_lookalike_parity(tmp_path):
  p = _write(tmp_path, 'fix.py', '''
      def helper():
          """Suppress with '# graftlint: allow[hetero-gate] why'."""
          return 1

      def check(self):
          if self.is_hetero:
              # graftlint: allow[hetero-gate] homo accessor by contract
              raise ValueError('homo-only')
      ''')
  assert assert_parity(p) == []
  assert core.run_lint([p], Config()).n_pragma == 1


# ------------------------------------------------------------------ baseline

TWO_GATES = '''
    def a(self):
        if self.is_hetero:
            raise ValueError('homo-only')

    def b(self):
        if self.is_hetero:
            raise ValueError('homo-only')
    '''


def test_baseline_round_trip_parity(tmp_path):
  """Each package writes the same baseline file for the same findings;
  each suppresses them with the other's file and still catches a new
  violation."""
  p = _write(tmp_path, 'fix.py', GATE.format(pragma=''))
  files = {}
  for name, mod in (('jax', jcore), ('port', core)):
    res = mod.run_lint([p], mod.Config())
    live = [f for f in res.findings if f.rule in SHARED]
    assert len(live) == 1
    files[name] = str(tmp_path / f'{name}.baseline.json')
    mod.write_baseline(files[name], live, res.modules)
  assert open(files['jax']).read() == open(files['port']).read()
  baseline = core.load_baseline(files['jax'])
  assert baseline == jcore.load_baseline(files['port']) and \
      len(baseline) == 1
  with open(p, 'a') as fh:
    fh.write('\n\ndef c(ds):\n    if ds.is_hetero:\n'
             '        raise NotImplementedError("typed")\n')
  for mod in (jcore, core):
    res = mod.run_lint([p], mod.Config(), baseline)
    live = [f for f in res.findings if f.rule in SHARED]
    assert len(live) == 1 and res.n_base == 1
    assert 'NotImplementedError' in live[0].message


def test_fingerprints_survive_line_motion_and_split_identical_lines(
    tmp_path):
  p = _write(tmp_path, 'fix.py', TWO_GATES)
  got = _both(p)
  fps = got['port'][1]
  assert fps == got['jax'][1] and len(set(fps)) == 2
  src = open(p).read()
  open(p, 'w').write('# a new leading comment\n' + src)
  assert _both(p)['port'][1] == fps == _both(p)['jax'][1]


def test_baseline_rejects_foreign_json(tmp_path):
  bad = tmp_path / 'graftlint.baseline.json'
  bad.write_text('{"some": "other file"}')
  for mod in (jcore, core):
    with pytest.raises(ValueError):
      mod.load_baseline(str(bad))


# ----------------------------------------------------------------------- CLI

def test_cli_exit_codes_match_jax(tmp_path, capsys):
  bad = _write(tmp_path, 'fix.py', GATE.format(pragma=''))
  good = _write(tmp_path, 'ok.py', 'x = 1\n')
  for main in (jlint_main, lint_main):
    assert main(['--list-rules']) == 0
    assert main([]) == 2
    assert main([bad, '--no-baseline']) == 1
    assert 'hetero-gate' in capsys.readouterr().out
    assert main([good, '--no-baseline']) == 0
    capsys.readouterr()
  lint_main(['--list-rules'])
  out = capsys.readouterr().out
  for rule in core.PRAGMA_RULES:
    assert rule in out


def test_cli_write_baseline_flow_matches_jax(tmp_path, capsys):
  for name, main in (('jax', jlint_main), ('port', lint_main)):
    d = tmp_path / name
    d.mkdir()
    _write(d, 'fix.py', GATE.format(pragma=''))
    base = str(d / 'graftlint.baseline.json')
    assert main([str(d), '--baseline', base, '--write-baseline']) == 0
    capsys.readouterr()
    assert main([str(d), '--baseline', base]) == 0
    assert 'baselined' in capsys.readouterr().out
  assert open(tmp_path / 'jax' / 'graftlint.baseline.json').read() == \
      open(tmp_path / 'port' / 'graftlint.baseline.json').read()


def test_default_baseline_is_the_packages_own(tmp_path, capsys):
  """The port's default baseline sits at the top of the linted package,
  never in the directory above it (where the JAX package keeps its
  own); ``--write-baseline`` writes only there."""
  assert tlint._default_baseline([PKG]) == os.path.join(
      PKG, 'graftlint.baseline.json')
  assert tlint._default_baseline([os.path.join(PKG, 'loader')]) == \
      os.path.join(PKG, 'graftlint.baseline.json')
  pkg = tmp_path / 'pkg'
  (pkg / 'sub').mkdir(parents=True)
  (pkg / '__init__.py').write_text('')
  (pkg / 'sub' / '__init__.py').write_text('')
  _write(pkg / 'sub', 'fix.py', GATE.format(pragma=''))
  above = tmp_path / 'graftlint.baseline.json'
  above.write_text('{"version": 1, "fingerprints": ["0000000000000000"]}')
  before = above.read_text()
  assert lint_main([str(pkg / 'sub'), '--write-baseline']) == 0
  assert above.read_text() == before
  assert len(core.load_baseline(str(pkg / 'graftlint.baseline.json'))) == 1
  capsys.readouterr()
  assert lint_main([str(pkg / 'sub')]) == 0
  assert 'baselined' in capsys.readouterr().out


# ------------------------------------------- brackets and locks, the corpus

def _corpus(prefixes):
  return sorted(n for n in os.listdir(CORPUS)
                if n.split('_')[0] in prefixes and n.endswith('.py'))


@pytest.mark.parametrize('name', _corpus(('brk', 'lock')))
def test_bracket_and_lock_fixtures_parity(name):
  found = assert_parity(os.path.join(CORPUS, name))
  rule = {'brk': 'bracket-discipline',
          'lock': 'lock-discipline'}[name.split('_')[0]]
  if name.endswith('_bug.py'):
    assert found and {f.rule for f in found} == {rule}, name
  else:
    assert found == [], name


# ---------------------------------------------------- the torch rules: pairs

HOST_SYNC_PAIRS = {
    'item_in_capture_lambda': ('''
        import torch
        from graphlearn_tpu_torch.loader.scan_epoch import capture_chunk

        class T:
            def _body(self, x):
                n = x.sum().item()
                return x * n

            def capture(self, stream, x):
                return capture_chunk(stream, lambda: self._body(x))
        ''', '''
        import torch
        from graphlearn_tpu_torch.loader.scan_epoch import capture_chunk

        class T:
            def _body(self, x):
                n = x.sum()
                return x * n

            def capture(self, stream, x):
                return capture_chunk(stream, lambda: self._body(x))
        '''),
    'cpu_in_graph_block': ('''
        import torch

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = x.cpu()
            return y
        ''', '''
        import torch

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = x * 2
            return y
        '''),
    'int_cast_in_step_body': ('''
        import torch

        class Trainer:
            def _make_body(self):
                def body(ids):
                    n = int(ids.max())
                    return torch.zeros(n)
                return body
        ''', '''
        import torch

        class Trainer:
            def _make_body(self, cap):
                def body(ids):
                    return torch.zeros(cap, device=ids.device)
                return body
        '''),
    'nonzero_vs_explicit': ('''
        import torch

        class Trainer:
            def _chunk(self, mask):
                return mask.nonzero()
        ''', '''
        import torch
        from graphlearn_tpu_torch.utils import strict

        class Trainer:
            def _chunk(self, mask):
                with strict.explicit():   # a deliberate read
                    return mask.nonzero()
        '''),
    'unique_and_masked_select': ('''
        import torch

        class Trainer:
            def _chunk(self, x, m):
                u = torch.unique(x)
                return torch.masked_select(u, m)
        ''', '''
        import torch

        class Trainer:
            def _chunk(self, x, m):
                return torch.where(m, x, torch.zeros_like(x))
        '''),
    'repeat_interleave_output_size': ('''
        import torch

        class Trainer:
            def _chunk(self, x, counts):
                return x.repeat_interleave(counts)
        ''', '''
        import torch

        class Trainer:
            def _chunk(self, x, counts, total):
                return x.repeat_interleave(counts, output_size=total)
        '''),
    'synchronize_and_events': ('''
        import torch

        class Trainer:
            def _chunk(self, x, event):
                torch.cuda.synchronize()
                event.synchronize()
                return x
        ''', '''
        import torch

        class Trainer:
            def _chunk(self, x, event, stream):
                stream.wait_event(event)
                return x
        '''),
    'to_cpu_numpy_tolist': ('''
        import numpy as np
        import torch

        class Trainer:
            def _chunk(self, x):
                a = x.to('cpu')
                b = x.to(device=torch.device('cpu'))
                c = np.asarray(x)
                return a, b, c, x.numpy(), x.tolist(), float(x), bool(x)
        ''', '''
        import numpy as np
        import torch

        class Trainer:
            def _chunk(self, x, device):
                a = x.to(device)
                b = torch.as_tensor(np.arange(4), device=x.device)
                return a, b, float(2), x.float()
        '''),
}
HOST_SYNC_COUNTS = {'to_cpu_numpy_tolist': 7, 'synchronize_and_events': 2,
                    'unique_and_masked_select': 2}

PRNG_PAIRS = {
    'split_and_carry': ('''
        from graphlearn_tpu_torch import random

        class Sampler:
            def draw(self):
                self._key, sub = random.split(self._key)
                return sub
        ''', '''
        from graphlearn_tpu_torch import random

        class Sampler:
            def draw(self):
                self._count += 1
                return random.fold_in(self._key, self._count)
        '''),
    'prngkey_in_loop': ('''
        from .. import random as trandom

        def redraw(n):
            out = []
            for i in range(n):
                out.append(trandom.PRNGKey(0))
            return out
        ''', '''
        from .. import random as trandom

        def redraw(n):
            base = trandom.PRNGKey(0)
            return [trandom.fold_in(base, i) for i in range(n)]
        '''),
    'generator_in_loop': ('''
        import torch

        def draws(n):
            out = []
            for i in range(n):
                g = torch.Generator().manual_seed(0)
                out.append(torch.rand(3, generator=g))
            return out
        ''', '''
        import torch

        def draws(n, seed):
            g = torch.Generator().manual_seed(seed)
            return [torch.rand(3, generator=g) for _ in range(n)]
        '''),
    'key_reuse': ('''
        from graphlearn_tpu_torch.random import randint, uniform

        def two_draws(key, shape):
            a = uniform(key, shape)
            b = randint(key, shape, 0, 9)
            return a, b
        ''', '''
        from graphlearn_tpu_torch.random import fold_in, randint, uniform

        def two_draws(key, shape):
            a = uniform(fold_in(key, 1), shape)
            b = randint(fold_in(key, 2), shape, 0, 9)
            return a, b
        '''),
}

DISPATCH_PAIRS = {
    'capture_chunk_container': ('''
        from graphlearn_tpu_torch.loader.scan_epoch import capture_chunk
        from graphlearn_tpu_torch.utils.trace import record_dispatch

        class Trainer:
            def _capture(self, stream, k):
                graph, out, launches, ms = capture_chunk(
                    stream, lambda: self._body(k))
                return graph

            def run(self, stream, k):
                g = self._graphs.get(k)
                if g is None:
                    g = self._graphs[k] = self._capture(stream, k)
                g.replay()
        ''', '''
        from graphlearn_tpu_torch.loader.scan_epoch import capture_chunk
        from graphlearn_tpu_torch.utils.trace import record_dispatch

        class Trainer:
            def _capture(self, stream, k):
                graph, out, launches, ms = capture_chunk(
                    stream, lambda: self._body(k))
                return graph

            def run(self, stream, k):
                g = self._graphs.get(k)
                if g is None:
                    g = self._graphs[k] = self._capture(stream, k)
                record_dispatch('chunk')
                g.replay()
        '''),
    'record_and_wrapper': ('''
        from typing import NamedTuple

        import torch

        class _Graph(NamedTuple):
            graph: object
            out: object

        class Trainer:
            def _capture(self, k):
                g = torch.cuda.CUDAGraph()
                return _Graph(g, k)

            def _replay(self, k):
                g = self._graphs[k]
                g.graph.replay()
                return g.out

            def run(self, k):
                self._graphs[k] = self._capture(k)
                return self._replay(k)
        ''', '''
        from typing import NamedTuple

        import torch
        from graphlearn_tpu_torch.utils.trace import record_dispatch

        class _Graph(NamedTuple):
            graph: object
            out: object

        class Trainer:
            def _capture(self, k):
                g = torch.cuda.CUDAGraph()
                return _Graph(g, k)

            def _replay(self, k):
                g = self._graphs[k]
                g.graph.replay()
                return g.out

            def run(self, k):
                self._graphs[k] = self._capture(k)
                record_dispatch('chunk')
                return self._replay(k)
        '''),
    'graph_attribute': ('''
        import torch

        class Engine:
            def __init__(self):
                self.graph = torch.cuda.CUDAGraph()

            def step(self):
                self.graph.replay()
        ''', '''
        import torch
        from graphlearn_tpu_torch.utils import trace

        class Engine:
            def __init__(self):
                self.graph = torch.cuda.CUDAGraph()

            def step(self):
                trace.record_dispatch('engine_step')
                self.graph.replay()
        '''),
}

TORCH_PAIRS = {('host-sync', 'hot_sync_modules', k): v
               for k, v in HOST_SYNC_PAIRS.items()}
TORCH_PAIRS.update({('prng-discipline', 'prng_modules', k): v
                    for k, v in PRNG_PAIRS.items()})
TORCH_PAIRS.update({('dispatch-instrumentation', 'dispatch_modules', k): v
                    for k, v in DISPATCH_PAIRS.items()})


@pytest.mark.parametrize('case', sorted(TORCH_PAIRS), ids=lambda c: c[2])
def test_torch_rule_catches_bug_and_passes_twin(tmp_path, case):
  rule, scope, name = case
  bug, fixed = TORCH_PAIRS[case]
  cfg = Config(**{scope: ('fix.py',)})
  p = _write(tmp_path, 'fix.py', bug)
  found = run_lint([p], cfg).findings
  assert _rules(found) == [rule] * HOST_SYNC_COUNTS.get(name, 1), \
      '\n'.join(f.render() for f in found)
  p = _write(tmp_path, 'fix.py', fixed)
  found = run_lint([p], cfg).findings
  assert found == [], '\n'.join(f.render() for f in found)
  # out of scope, the bug is not this rule's business
  p = _write(tmp_path, 'elsewhere.py', bug)
  assert [f for f in run_lint([p], cfg).findings if f.rule == rule] == []


def test_host_sync_roots_name_the_symbol_and_skip_host_helpers(tmp_path):
  p = _write(tmp_path, 'fix.py', '''
      import torch
      from graphlearn_tpu_torch.utils.trace import record_dispatch

      def host_summary(arr):
          return arr.item()

      class Trainer:
          def _chunk(self, x):
              return x.item()

          def _make_wrapper(self, fn):
              def wrapper(x):
                  record_dispatch('w')
                  return fn(x).item()
              return wrapper
      ''')
  found = run_lint([p], Config(hot_sync_modules=('fix.py',))).findings
  assert [(f.rule, f.symbol) for f in found] == [
      ('host-sync', 'Trainer._chunk')]
  # the step functions the config names are roots
  found = run_lint([p], Config(hot_sync_modules=('fix.py',),
                               traced_step_functions=())).findings
  assert found == []


# JAX's prng snippets (tests/test_analysis.py) and their rewrites onto the
# port's random module: the same findings at the same places
PRNG_JAX = {
    'split_and_carry': ('''
        import jax

        class Sampler:
            def draw(self):
                self._key, sub = jax.random.split(self._key)
                return sub
        ''', '''
        import graphlearn_tpu_torch as gtt

        class Sampler:
            def draw(self):
                self._key, sub = gtt.random.split(self._key)
                return sub
        '''),
    'prngkey_in_loop': ('''
        import jax

        def redraw(n):
            out = []
            for i in range(n):
                out.append(jax.random.PRNGKey(0))
            return out
        ''', '''
        import graphlearn_tpu_torch.random as jr

        def redraw(n):
            out = []
            for i in range(n):
                out.append(jr.PRNGKey(0))
            return out
        '''),
    'key_reuse': ('''
        import jax

        def two_draws(key, shape):
            a = jax.random.uniform(key, shape)
            b = jax.random.normal(key, shape)
            return a, b
        ''', '''
        from graphlearn_tpu_torch import random

        def two_draws(key, shape):
            a = random.uniform(key, shape)
            b = random.permutation(key, shape)
            return a, b
        '''),
    'numpy_host_rng': ('''
        import numpy as np

        def two_perms(order):
            a = np.random.permutation(order)
            b = np.random.permutation(order)
            return a, b
        ''', '''
        import random

        import numpy as np

        def two_perms(order, lo, hi):
            a = np.random.permutation(order)
            b = np.random.permutation(order)
            return a, b, random.uniform(lo, hi), random.uniform(lo, hi)
        '''),
    'counter_pattern': ('''
        import jax

        class Sampler:
            def _keys_for(self, count, nparts):
                k = jax.random.fold_in(self._key, count)
                return jax.random.split(k, nparts)

            def draw(self, key, shape):
                ka = jax.random.fold_in(key, 1)
                a = jax.random.uniform(ka, shape)
                kb = jax.random.fold_in(key, 2)
                b = jax.random.uniform(kb, shape)
                return a, b
        ''', '''
        from .. import random as trandom

        class Sampler:
            def _keys_for(self, count, nparts):
                k = trandom.fold_in(self._key, count)
                return trandom.split(k, nparts)

            def draw(self, key, shape):
                ka = trandom.fold_in(key, 1)
                a = trandom.uniform(ka, shape)
                kb = trandom.fold_in(key, 2)
                b = trandom.uniform(kb, shape)
                return a, b
        '''),
}


@pytest.mark.parametrize('case', sorted(PRNG_JAX))
def test_prng_rewrites_find_what_jax_finds(tmp_path, case):
  jsrc, tsrc = PRNG_JAX[case]
  (tmp_path / 'j').mkdir()
  (tmp_path / 't').mkdir()
  jp = _write(tmp_path / 'j', 'fix.py', jsrc)
  tp = _write(tmp_path / 't', 'fix.py', tsrc)
  def what(f):   # the message's head, with the module's name dropped
    return f.message.replace('jax.random.', 'random.').split(' — ')[0] \
        .split(':')[0]

  want = [(f.rule, f.line, f.col, f.symbol, what(f))
          for f in jcore.run_lint([jp], jcore.Config(
              prng_modules=('fix.py',))).findings]
  got = [(f.rule, f.line, f.col, f.symbol, what(f))
         for f in run_lint([tp], Config(prng_modules=('fix.py',))).findings]
  assert got == want


# ------------------------------------------ faults put back into the port

def _copy_with(tmp_path, rel, old, new):
  src = open(os.path.join(PKG, rel)).read()
  assert src.count(old) >= 1, (rel, old)
  path = tmp_path / os.path.basename(rel)
  path.write_text(src.replace(old, new, 1))
  return str(path)


def test_item_inserted_into_scan_epoch_is_flagged(tmp_path):
  anchor = '\n      ovf = ovf | overflow\n'
  p = _copy_with(tmp_path, 'loader/scan_epoch.py', anchor,
                 anchor + '      stop = overflow.item()\n')
  cfg = Config(hot_sync_modules=('scan_epoch.py',))
  found = [f for f in run_lint([p], cfg).findings if f.rule == 'host-sync']
  assert [(f.symbol, 'item' in f.message) for f in found] == [
      ('ScanTrainer._chunk', True)]
  clean = tmp_path / 'clean'
  clean.mkdir()
  q = _copy_with(clean, 'loader/scan_epoch.py', anchor, anchor)
  assert [f for f in run_lint([q], cfg).findings
          if f.rule == 'host-sync'] == []


@pytest.mark.parametrize('rel,anchor', [
    ('loader/scan_epoch.py', '        record_dispatch(site_chunk)\n'),
    ('distributed/remote_scan.py',
     "          record_dispatch('remote_scan_chunk')\n")])
def test_unrecorded_replay_in_a_port_trainer_is_flagged(tmp_path, rel,
                                                        anchor):
  p = _copy_with(tmp_path, rel, anchor, '')
  base = os.path.basename(rel)
  found = [f for f in run_lint([p], Config(dispatch_modules=(base,)))
           .findings if f.rule == 'dispatch-instrumentation']
  # the replay's wrappers carry no record of their own, so the finding
  # lands where the wrapping chain leaves the module's callers
  assert len(found) == 1, '\n'.join(f.render() for f in found)
  assert found[0].symbol.endswith('run_epoch')


def test_pipeline_bracket_leak_is_flagged_when_put_back(tmp_path):
  old = ("    try:\n      # inside the bracket, as JAX's: a failed "
         "allocation still closes\n      # the epoch's flight record\n"
         "      ovf = torch.zeros((), dtype=torch.bool, device=device)  "
         "# trained ones'\n")
  new = ("    ovf = torch.zeros((), dtype=torch.bool, device=device)\n"
         "    try:\n")
  p = _copy_with(tmp_path, 'loader/pipeline.py', old, new)
  found = [f for f in run_lint([p], Config()).findings
           if f.rule == 'bracket-discipline']
  assert [f.symbol for f in found] == ['OverlappedTrainer.run_epoch']
  assert "flight_tok" in found[0].message


def test_unlocked_launch_counter_is_flagged(tmp_path):
  p = _copy_with(tmp_path, 'ops/draw.py',
                 '  with kernels.COUNT_LOCK:\n    launches += 1\n',
                 '  launches += 1\n')
  found = run_lint([p], Config()).findings
  assert _rules(found) == ['lock-discipline']
  assert 'kernels.COUNT_LOCK' in found[0].message


# -------------------------------------------------------------- the gate

@pytest.fixture(scope='module')
def port_lint():
  """One walk of the port with its own baseline, shared by the gate."""
  path = os.path.join(PKG, core.BASELINE_NAME)
  return core.load_baseline(path), run_lint([PKG], Config(),
                                            core.load_baseline(path))


def test_port_is_clean_with_an_empty_baseline(port_lint):
  baseline, res = port_lint
  assert baseline == set()
  assert res.n_base == 0
  assert res.findings == [], 'graftlint findings:\n' + '\n'.join(
      f.render() for f in res.findings)
  assert len(res.modules) >= 140   # really walked the package


def test_every_rule_ran_and_every_pragma_has_a_reason(port_lint):
  _, res = port_lint
  assert set(res.timings) == set(core.PRAGMA_RULES)
  rx = re.compile(r'#\s*graftlint:\s*allow\[([^\]]+)\]\s*(\S.*)$')
  allows = []
  for mod in res.modules.values():
    for line, text, _ in core._pragma_comments(mod):
      if 'allow[' in text:
        m = rx.search(text)
        assert m and m.group(2).strip(), f'{mod.relpath}:{line}'
        allows.append((mod.relpath, m.group(1)))
  # every pragma suppressed a live finding: none is stale
  assert res.n_pragma == len(allows) == 12
  assert sorted({r for _, r in allows}) == ['hetero-gate', 'host-sync',
                                            'metric-registry']


def test_port_carries_the_lock_annotations(port_lint):
  _, res = port_lint
  got = {}
  rx = re.compile(r'graftlint:\s*(shared|locked)\[([^\]]+)\]')
  for mod in res.modules.values():
    if mod.relpath.startswith('analysis/'):
      continue   # the grammar's own documentation
    for _, text, _ in core._pragma_comments(mod):
      m = rx.search(text)
      if m:
        got.setdefault(mod.relpath, []).append(m.groups())
  # JAX's 14 on the same fields, the 15 launch counters and the hot/cold
  # kernel's 2 fetch counters
  assert sum(len(v) for v in got.values()) == 14 + 15 + 2
  assert sorted({k for k, v in got.items()
                 if ('shared', 'kernels.COUNT_LOCK') in v}) == [
      'ops/draw.py', 'ops/gather.py', 'ops/keys.py', 'ops/negative.py',
      'ops/probes.py', 'ops/sample_fused.py']
  assert ('locked', '_lock') in got['distributed/tenancy.py']


def test_analyzer_imports_neither_package_nor_jax_nor_torch():
  blocked = ('jax', 'jaxlib', 'torch', 'numpy', 'graphlearn_tpu',
             'graphlearn_tpu_torch')
  names = sorted(n for n in os.listdir(ANALYSIS) if n.endswith('.py'))
  assert len(names) == 14
  for n in names:
    tree = ast.parse(open(os.path.join(ANALYSIS, n)).read())
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        mods = [node.module or ''] if node.level == 0 else []
      else:
        continue
      for m in mods:
        assert m.split('.')[0] not in blocked, (n, m)


def test_cli_json_and_timings_over_a_slice_of_the_port(capsys):
  rc = lint_main(['--format', 'json', '--timings',
                  os.path.join(PKG, 'utils')])
  doc = json.loads(capsys.readouterr().out)
  assert rc == 0 and doc['findings'] == [] and doc['files'] >= 10
  assert set(doc['timings_ms']) == set(core.PRAGMA_RULES)
