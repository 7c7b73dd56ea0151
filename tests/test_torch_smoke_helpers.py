"""chip_smoke.py's helpers, on the CPU: the rule that records a profiled
window again when the profiler lost records, the issue model behind the
operation bounds, and the SASS reading that feeds it.

chip_smoke.py is loaded from the checkout root; its top level imports
only the standard library and numpy.
"""
import importlib.util
import pathlib

import numpy as np
import pytest


@pytest.fixture(scope='module')
def cs():
  path = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'
  spec = importlib.util.spec_from_file_location('chip_smoke_helpers', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture
def fresh(cs):
  """The module with its window reports emptied."""
  cs.PROFILE_EMPTY_WINDOWS.clear()
  cs.PROFILE_SHORT_WINDOWS.clear()
  yield cs
  cs.PROFILE_EMPTY_WINDOWS.clear()
  cs.PROFILE_SHORT_WINDOWS.clear()


# ------------------------------------------------------------- re-record

WANT = dict(gather_rows=96, sample_hop=36, step_keys=3)
EXACT = dict(WANT)
SHORT = dict(WANT, gather_rows=92)
OVER = dict(WANT, sample_hop=37)
EMPTY = {}


class Recorder:
  """A fake recorder: each call gives the next trace (a dict of the port
  kernels' counts), counting the calls and the resets between them."""

  def __init__(self, traces):
    self.traces = list(traces)
    self.calls = self.resets = 0

  def record(self):
    trace = self.traces[min(self.calls, len(self.traces) - 1)]
    self.calls += 1
    return trace, 1.0

  def reset(self):
    self.resets += 1


@pytest.mark.parametrize('traces,calls,final,shorts,empties', [
    # a short count, then an exact one: passes, logged as re-recorded
    ((SHORT, EXACT), 2, 'exact', 1, 0),
    # short three times: the window stays short and the check fails
    ((SHORT, SHORT, SHORT), 3, 'short', 2, 0),
    # over the counters: fails at once, never recorded again
    ((OVER, EXACT), 1, 'over', 0, 0),
    # a trace with no device event is recorded again, as before
    ((EMPTY, EXACT), 2, 'exact', 0, 1),
    # exact at once: one recording
    ((EXACT,), 1, 'exact', 0, 0),
    # empty, then short, then exact: both rules share the two retries
    ((EMPTY, SHORT, EXACT), 3, 'exact', 1, 1),
], ids=['short_then_exact', 'short_thrice', 'over', 'empty_then_exact',
        'exact', 'empty_short_exact'])
def test_record_window_rerecords_short_and_empty_windows(
    fresh, traces, calls, final, shorts, empties):
  rec = Recorder(traces)
  trace, wall = fresh.record_window(
      rec.record, 'epoch', lambda t: t, empty=lambda t: not t,
      expect=lambda: dict(WANT), reset=rec.reset,
      where=lambda t: dict(first_device_ms=0.5))
  assert rec.calls == calls and rec.resets == calls - 1
  assert wall == 1.0
  assert fresh.count_verdict(trace, WANT)[0] == final
  assert len(fresh.PROFILE_SHORT_WINDOWS) == shorts
  assert fresh.PROFILE_EMPTY_WINDOWS == ['epoch'] * empties
  for entry in fresh.PROFILE_SHORT_WINDOWS:
    assert entry == dict(label='epoch', short=dict(gather_rows=4),
                         first_device_ms=0.5)
  if final != 'exact':
    # the site's check, unchanged: the window's counts equal the counters
    with pytest.raises(AssertionError):
      assert trace == WANT, (trace, WANT)


def test_record_window_without_counters_keeps_the_first_window(fresh):
  rec = Recorder((SHORT, EXACT))
  trace, _ = fresh.record_window(rec.record, 'loop', lambda t: t)
  assert rec.calls == 1 and trace == SHORT
  assert not fresh.PROFILE_SHORT_WINDOWS


@pytest.mark.parametrize('traces,calls,final', [
    # the drill's first recording lost one launch: recorded again, exact
    ((EXACT, EXACT), 2, 'exact'),
    # a window that really lost records after the drill: the one retry
    # left records it again
    ((EXACT, SHORT, EXACT), 3, 'exact'),
], ids=['drill_then_exact', 'drill_then_short_then_exact'])
def test_record_window_drill_drops_a_record_once(fresh, traces, calls,
                                                 final):
  rec = Recorder(traces)

  def drop(trace):
    return dict(trace, gather_rows=trace['gather_rows'] - 1)

  trace, _ = fresh.record_window(
      rec.record, 'epoch', lambda t: t, expect=lambda: dict(WANT),
      reset=rec.reset, drop=drop)
  assert rec.calls == calls and rec.resets == calls - 1
  assert fresh.count_verdict(trace, WANT)[0] == final
  entries = fresh.PROFILE_SHORT_WINDOWS
  assert entries[0] == dict(label='epoch', short=dict(gather_rows=1),
                            drill=True)
  assert all('drill' not in e for e in entries[1:])
  assert len(entries) == calls - 1


def test_drop_one_port_record_takes_the_first_port_kernel(cs):
  dev = [('Memcpy HtoD', 0.0, 1.0, 7),
         ('void hop_slot_kernel(int const*)', 1.0, 2.0, 7),
         ('void gather_rows_kernel<4>(...)', 2.0, 3.0, 7),
         ('void hop_slot_kernel(int const*)', 3.0, 4.0, 7)]
  got, window = cs.drop_one_port_record((dev, (0.0, 5.0)))
  assert window == (0.0, 5.0)
  assert got == [dev[0], dev[2], dev[3]]
  host = [('Memcpy HtoD', 0.0, 1.0, 7)]
  assert cs.drop_one_port_record((host, (0.0, 1.0))) == (host, (0.0, 1.0))


class Loader:
  """A loader whose epochs are ``n`` numbered batches."""

  def __init__(self, n):
    self.n, self.epochs = n, 0

  def __iter__(self):
    self.epochs += 1
    return iter([(self.epochs, j) for j in range(self.n)])


def test_batches_goes_on_into_a_new_epoch(cs):
  loader = Loader(4)
  it = iter(loader)
  assert next(it) == (1, 0)
  seen = []
  more = cs.Batches(loader, it, first=seen.append)
  assert [more() for _ in range(5)] == [(1, 1), (1, 2), (1, 3), (2, 0),
                                        (2, 1)]
  assert more.rolled and seen == [(1, 1), (1, 2), (1, 3)]
  assert list(more.it) == [(2, 2), (2, 3)]


class FakeCuda:
  capturing = False

  def is_current_stream_capturing(self):
    return self.capturing


class FakeTorch:
  def __init__(self):
    self.cuda = FakeCuda()


def test_shape_tally_counts_launches_and_replays_by_shape(cs):
  torch, tally = FakeTorch(), cs.ShapeTally()
  tally.launched(torch, 'uniform_draw', (768000,))
  tally.launched(torch, 'uniform_draw', (768000,))
  tally.paused += 1            # timed(): a measurement counts nothing
  tally.launched(torch, 'uniform_draw', (768000,))
  tally.paused -= 1

  class Graph:
    pass

  graph = Graph()              # what the capture_begin hook does
  graph._glt_tally = []
  tally.local.graph = graph
  torch.cuda.capturing = True
  tally.launched(torch, 'step_keys', (8, 3))
  tally.launched(torch, 'uniform_draw', (25,))
  torch.cuda.capturing = False
  tally.local.graph = None
  assert tally.shapes() == {'uniform_draw': {'[768000]': 2}}
  for _ in range(3):           # each replay counts the captured launches
    tally.add(graph._glt_tally)
  assert tally.shapes() == {'uniform_draw': {'[768000]': 2, '[25]': 3},
                            'step_keys': {'[8, 3]': 3}}


def test_tally_shapes_read_the_launch_arguments(cs):
  args = dict(glt_uniform_draw=(1, 768000, 2, 0, 0),
              glt_step_keys=(1, 2, 8, 3, 4, 0, 0),
              glt_dist_step_keys=(1, 2, 4, 4, 3, 5, 0, 0),
              glt_negative_sample=(1, 2, 3, 4, 5, 6, 7, 2560, 9),
              glt_negative_sample_local=(1, 2, 3, 4, 5, 6, 7, 8, 2560, 10))
  got = {fn: cs.TALLY_SHAPES[fn][1](a) for fn, a in args.items()}
  assert got == dict(glt_uniform_draw=(768000,), glt_step_keys=(8, 3),
                     glt_dist_step_keys=(4, 4, 3),
                     glt_negative_sample=(2560,),
                     glt_negative_sample_local=(2560,))


def test_never_redesigned_ranking_by_the_launches_at_each_shape(cs):
  def rec(ms, yard, **kw):
    return dict(kw, ms=ms, bound_ms=yard / 2, bound_by='operations',
                fill_ms=yard, yardstick_ms=yard)

  ktab = dict(
      uniform_draw=[rec(0.0085, 0.0062, shape=[153600, 5], words=768000),
                    rec(0.0954, 0.0688, shape=[25000000],
                        words=25000000)],
      step_keys=rec(0.0055, 0.0053, steps=8, hops=3),
      negative_sample=[rec(0.008, 0.0053, candidates=2560),
                       rec(0.0129, 0.0057, candidates=163840)])
  dkeys = rec(0.0056, 0.0053, steps=4, parts=4, hops=3)
  nloc = rec(0.0084, 0.0054, candidates=2560)
  shapes = dict(uniform_draw={'[768000]': 10, '[25000000]': 2,
                              '[153600]': 7},
                step_keys={'[8, 3]': 100},
                negative_sample={'[2560]': 30})
  got = cs.never_redesigned_ranking(ktab, dkeys, nloc, shapes)
  ranked = [(r['kernel'], r['shape'], r['launches']) for r in got['ranked']]
  # launches x gap: 0.0532, 0.0231, 0.0810, 0.0200
  assert ranked == [('negative_sample', [2560], 30),
                    ('uniform_draw', [25000000], 2),
                    ('uniform_draw', [153600, 5], 10),
                    ('step_keys', [8, 3], 100)]
  assert got['ranked'][0]['launches_x_gap_ms'] == pytest.approx(
      30 * (0.008 - 0.0053))
  assert [(r['kernel'], r['shape']) for r in got['not_launched']] == [
      ('dist_step_keys', [4, 4, 3]), ('negative_sample', [163840]),
      ('negative_sample_local', [2560])]
  assert got['untimed'] == dict(uniform_draw={'[153600]': 7})
  assert shapes['uniform_draw']['[768000]'] == 10     # the input is kept


@pytest.mark.parametrize('seen,want,verdict,short', [
    (EXACT, WANT, 'exact', {}),
    (SHORT, WANT, 'short', dict(gather_rows=4)),
    (dict(WANT, gather_rows=0, step_keys=1), WANT, 'short',
     dict(gather_rows=96, step_keys=2)),
    (OVER, WANT, 'over', {}),
    (dict(SHORT, sample_hop=37), WANT, 'over', {}),
    (dict(WANT, uniform_draw=1), WANT, 'over', {}),
    ({}, WANT, 'short', WANT),
], ids=['exact', 'short', 'two_short', 'over', 'short_and_over',
        'unknown_kernel', 'empty'])
def test_count_verdict(cs, seen, want, verdict, short):
  assert cs.count_verdict(seen, want) == (verdict, short)


# ------------------------------------------------------------ the bounds

@pytest.mark.parametrize('instr,limit', [
    (dict(alu=6400, fma=640, total=9600), 'alu'),
    (dict(alu=640, fma=6400, total=9600), 'fma'),
    (dict(alu=6000, fma=6000, total=12800), 'issue'),
    (dict(alu=0, fma=0, total=128), 'issue'),
], ids=['alu', 'fma', 'issue', 'issue_only'])
def test_issue_quotients_and_which_bounds(cs, instr, limit):
  clock, sms = 1e9, 2
  q = cs.issue_quotients(instr, clock, sms)
  clocks_a_ms = sms * clock / 1e3
  assert q['alu'] == pytest.approx(instr['alu'] / 64 / clocks_a_ms)
  assert q['fma'] == pytest.approx(instr['fma'] / 64 / clocks_a_ms)
  assert q['issue'] == pytest.approx(instr['total'] / 128 / clocks_a_ms)
  assert max(q, key=q.get) == limit


def need(alu=0, fma=0, either=0, add3=0, total=0):
  return dict(alu=alu, fma=fma, either=either, add3=add3, total=total)


@pytest.mark.parametrize('instr,clocks,moved', [
    # the draw's word: its 3-input adds all run as two IMADs each, and
    # the ALU-only instructions bound it
    (need(alu=46, either=19, add3=10, total=78), 46 / 64, 10),
    # the FMA-only instructions bound it: nothing moves
    (need(alu=10, fma=100, add3=10, total=130), 100 / 64, 0),
    # the moves cost issue slots: they stop where the falling ALU
    # quotient meets the issue's (which always comes before the FMA's)
    (need(alu=40, either=20, add3=40, total=100), (80 - 20) / 64, 20),
    # no 3-input add: nothing moves
    (need(alu=64, fma=8, total=100), 1.0, 0),
], ids=['draw_word', 'fma_bound', 'alu_meets_issue', 'none'])
def test_issue_quotients_place_three_input_adds(cs, instr, clocks, moved):
  """The least over every share of the 3-input adds run as two IMADs,
  against a brute-force search of that share."""
  q = cs.issue_quotients(instr, 1e3, 1)           # one clock a ms
  assert max(q.values()) == pytest.approx(clocks)
  assert q['alu'] == pytest.approx((instr['alu'] + instr['add3'] - moved) /
                                   64)
  best = min(max((instr['alu'] + instr['add3'] - y) / 64,
                 (instr['fma'] + 2 * y) / 64, (instr['total'] + y) / 128)
             for y in np.linspace(0, instr['add3'], 4001))
  assert max(q.values()) == pytest.approx(best, rel=1e-3)


def test_bound_takes_the_larger_of_bytes_and_issue(cs):
  instr = dict(alu=64 * 132 * 1980, fma=0, total=64 * 132 * 1980)
  # 1980 ALU clocks a SM: 1 us at 1.98 GHz
  assert cs.issue_ms(instr, 1.98e9) == pytest.approx(1e-3)
  assert cs.bound_ms(0, instr) == pytest.approx(1e-3)
  assert cs.bound_by(0, instr) == 'operations'
  many = int(1e-3 / 1e3 * cs.H100_BYTES_PER_S) * 2   # 2 us of bytes
  assert cs.bound_ms(many, instr) == pytest.approx(2e-3)
  assert cs.bound_by(many, instr) == 'bytes'
  assert cs.bound_ms(many) == pytest.approx(2e-3)
  assert cs.issue_ms({}) == 0.0


def test_draw_at_25m_words_old_rate_and_recounted(cs):
  """The padded table's build draws one word an edge ([25M] at the
  script's graph). Before the recount: 85 operations a word over 67 T/s
  (the float32 rate, an FMA counted twice). Recounted: the word's SASS
  on the card (78 instructions: 46 that only the ALU pipe runs, 19 adds
  and moves either pipe runs, 10 3-input adds) over the issue model at
  the H100's 1,980 MHz SM clock: the 3-input adds go to the FMA pipe as
  two IMADs each, the ALU-only instructions bound it, 2.2 times the old
  figure."""
  words, nbytes = 25_000_000, 16 + 4 * 25_000_000
  old = max(nbytes / cs.H100_BYTES_PER_S,
            cs.DRAW_OPS * words / cs.H100_OPS_PER_S) * 1e3
  assert old == pytest.approx(0.031716, rel=1e-4)
  per_word = need(alu=46, either=19, add3=10, total=78)
  instr = {k: v * words for k, v in per_word.items()}
  q = cs.issue_quotients(instr, 1.98e9)
  assert max(q, key=q.get) == 'alu'
  assert q['alu'] == pytest.approx(words * 46 / 64 / (132 * 1.98e9) * 1e3)
  assert q['fma'] == pytest.approx(words * 20 / 64 / (132 * 1.98e9) * 1e3)
  assert q['issue'] == pytest.approx(words * 88 / 128 / (132 * 1.98e9) *
                                     1e3)
  new = cs.bound_ms(nbytes, instr) if cs.SM_CLOCK_HZ == 1.98e9 else None
  assert new == pytest.approx(0.068751, rel=1e-4)
  assert cs.bound_by(nbytes, instr) == 'operations'
  assert new / old == pytest.approx(2.1677, rel=1e-3)


# --------------------------------------------------------------- the SASS

def sass(name, body):
  """cuobjdump -sass text of one function: ``body`` a list of
  instruction strings (``'@P0 BRA {3}'`` names the address of
  instruction 3), the dead self-branch and NOPs after it."""
  lines = ['\tcode for sm_90a', f'\t\tFunction : {name}',
           '\t.headerflags\t@"EF_CUDA_SM90"']
  body = list(body) + ['EXIT', 'BRA {self}', 'NOP', 'NOP']
  for j, ins in enumerate(body):
    text = ins.format(*[f'0x{16 * k:x}' for k in range(len(body))],
                      self=f'0x{16 * j:x}')
    pred = ''
    if text.startswith('@'):
      pred, text = text.split(' ', 1)
    lines.append(f'        /*{16 * j:04x}*/ {pred:>18} {text} ;'
                 f'   /* 0x000fe20000000800 */')
    lines.append('                                              '
                 '/* 0x000fc80000000000 */')
  return '\n'.join(lines) + '\n'


ROUND = ['IMAD.IADD R8, R8, 0x1, R7', 'SHF.L.W.U32.HI R7, R7, 0xd, R7',
         'LOP3.LUT R7, R7, R8, RZ, 0x3c, !PT']
# 40 ALU only, 20 either pipe, one 3-input add
THREEFRY = ROUND * 20 + ['IADD3 R7, R7, 0x1, R4']


def test_sass_functions_drop_nops_and_dead_code(cs):
  fns = cs.sass_functions(sass('_Z3fooPi', ['LDC R1, c[0x0][0x28]',
                                            'ULDC UR4, c[0x0][0x0]']))
  assert list(fns) == ['_Z3fooPi']
  assert [op for _, op, _ in fns['_Z3fooPi']] == ['LDC', 'ULDC', 'EXIT']


@pytest.mark.parametrize('opcode,operands,pipe', [
    ('IADD3', 'R7, R7, 0x1, R4', 'add3'), ('IADD3', 'R7, R6, R0, RZ', 'either'),
    ('IADD3', 'R2, P0, R2, UR6, RZ', 'alu'),
    ('IADD3.X', 'R5, R5, UR4, RZ, P0, !PT', 'either'),
    ('LOP3.LUT', '', 'alu'), ('SHF.L.W.U32.HI', '', 'alu'),
    ('ISETP.GE.U32.AND', '', 'alu'), ('SEL', '', 'alu'),
    ('LEA.HI.X', '', 'alu'), ('LEA', '', 'either'),
    ('IMAD.IADD', '', 'either'), ('IMAD.MOV.U32', '', 'either'),
    ('IMAD.SHL.U32', '', 'either'), ('IMAD.X', '', 'either'),
    ('IMAD', '', 'fma'), ('IMAD.WIDE.U32', '', 'fma'),
    ('IMAD.HI.U32', '', 'fma'), ('FADD', '', None), ('FFMA', '', None),
    ('ULDC.64', '', None), ('STG.E', '', None), ('BRA', '', None),
    ('MUFU.RCP', '', None), ('F2I.FLOOR.NTZ', '', None),
    ('VIADD', '', 'either'), ('MOV', '', 'either'),
], ids=['IADD3-three', 'IADD3-two', 'IADD3-carry', 'IADD3.X-two',
        'LOP3.LUT-alu', 'SHF.L.W.U32.HI-alu', 'ISETP.GE.U32.AND-alu',
        'SEL-alu', 'LEA.HI.X-alu', 'LEA-either', 'IMAD.IADD-either',
        'IMAD.MOV.U32-either', 'IMAD.SHL.U32-either', 'IMAD.X-either',
        'IMAD-fma', 'IMAD.WIDE.U32-fma', 'IMAD.HI.U32-fma', 'FADD-None',
        'FFMA-None', 'ULDC.64-None', 'STG.E-None', 'BRA-None',
        'MUFU.RCP-None', 'F2I.FLOOR.NTZ-None', 'VIADD-either',
        'MOV-either'])
def test_sass_pipes_assigns_each_opcode(cs, opcode, operands, pipe):
  got = cs.sass_pipes([(0, opcode, operands)])
  want = need(total=1)
  if pipe is not None:
    want[pipe] = 1
  assert got == want


@pytest.mark.parametrize('unroll', [1, 2], ids=['one_word', 'two_words'])
def test_sass_unit_loop_counts_a_stored_word(cs, unroll):
  body = (['S2R R0, SR_TID.X', '@P0 EXIT'] +
          (THREEFRY + ['STG.E desc[UR8][R6.64], R9']) * unroll +
          ['ISETP.GE.U32.AND P0, PT, R2, UR10, PT', '@!P0 BRA {2}'])
  ins = cs.sass_functions(sass('_Z4drawPf', body))['_Z4drawPf']
  unit = cs.sass_unit(ins, 'loop')['']
  # per word: the threefry (40 ALU only, 20 either pipe, a 3-input add;
  # 61), its store, and the loop's compare and branch shared by the words
  # of an iteration
  assert unit == need(alu=40 + 1 / unroll, either=20, add3=1,
                      total=62 + 2 / unroll)


def test_sass_unit_draw_is_the_least_region_a_branch_skips(cs):
  body = (['S2R R0, SR_TID.X', '@!P1 BRA {69}',       # skips all: larger
           'ISETP.GT.AND P0, PT, R4, UR4, PT', '@!P0 BRA {67}'] +
          THREEFRY + ['FADD R0, R0, -1', 'F2I.FLOOR.NTZ R0, R0',
                      'BSYNC B1', 'STG.E desc[UR8][R6.64], R7'])
  assert len(body) == 69               # sass() appends the EXIT at 69
  ins = cs.sass_functions(sass('_Z3hopPi', body))['_Z3hopPi']
  # the threefry, the float step and the floor: what branch 3 skips
  assert cs.sass_unit(ins, 'draw') == {'': need(alu=40, either=20, add3=1,
                                                total=63)}


@pytest.mark.parametrize('how', ['search', 'search+count'])
def test_sass_unit_search_splits_candidate_and_rounds(cs, how):
  rnd = ['LDG.E.CONSTANT R19, desc[UR8][R18.64]',
         'ISETP.GE.AND P0, PT, R19, R5, PT', 'SEL R2, R3, R2, P0',
         'IMAD.IADD R3, R2, 0x1, R4', '@P0 BRA {exit}']
  count = (['IMAD.SHL.U32 R2, R2, 0x2, RZ',
            'ISETP.GE.AND P3, PT, R2, R9, PT', '@!P3 BRA {1}']
           if how == 'search+count' else [])
  body = ['S2R R0, SR_TID.X'] + count
  head = len(body)
  body += THREEFRY + rnd * 4 + ['STG.E desc[UR8][R6.64], R7',
                                '@!P2 BRA {%d}' % head]
  # the exits leave the loop for the EXIT that sass() appends
  body = [b.replace('{exit}', '{%d}' % len(body)) for b in body]
  ins = cs.sass_functions(sass('_Z3negPi', body))['_Z3negPi']
  got = cs.sass_unit(ins, how)
  assert got['.round'] == need(alu=2, either=1, total=5)
  # the loop (its head to its branch) less its four rounds
  assert got['.candidate'] == need(alu=40, either=20, add3=1, total=61 + 2)
  if how == 'search+count':
    assert got['.count_round'] == need(alu=1, either=1, total=3)
  else:
    assert '.count_round' not in got


def test_sass_unit_counts_finds_each_kernel_by_its_mangled_name(cs):
  loop = (['@P0 EXIT'] + THREEFRY +
          ['STG.E desc[UR8][R6.64], R9', '@!P0 BRA {1}'])
  keys = ['S2R R0, SR_TID.X'] + THREEFRY * 2 + ['STG.E.64 desc[UR8][R2.64], R4']
  texts = dict(
      uniform_draw=sass('_ZN12_GLOBAL__N_119uniform_draw_kernelEPKxxPf',
                        loop),
      step_keys=(sass('_ZN12_GLOBAL__N_116step_keys_kernelEPKxS1_iiPx',
                      keys) +
                 sass('_ZN12_GLOBAL__N_121dist_step_keys_kernelEPKx',
                      keys + THREEFRY)))
  specs = [sp for sp in cs.SASS_UNIT_SPECS if sp[1] in texts]
  saved = cs.SASS_UNIT_SPECS
  try:
    cs.SASS_UNIT_SPECS = tuple(specs)
    units = cs.sass_unit_counts(texts)
  finally:
    cs.SASS_UNIT_SPECS = saved
  assert units['uniform_draw.word'] == need(alu=40, either=20, add3=1,
                                            total=63)
  # step_keys_kernel is not dist_step_keys_kernel: 2 and 3 threefry blocks
  assert units['step_keys.key'] == need(alu=80, either=40, add3=2,
                                        total=125)
  assert units['dist_step_keys.key'] == need(alu=120, either=60, add3=3,
                                             total=186)


# ---------------------------------------------------------- the wall time

def warp_search(ids, pad=np.iinfo(np.int32).max):
  """The local negative kernel's 32-ary count search, lane by lane:
  ``(count, loop steps)``."""
  lo, hi, steps = 0, len(ids), 0
  while hi - lo > 32:
    step = -(-(hi - lo) // 32)
    at = [lo + (lane + 1) * step - 1 for lane in range(32)]
    below = sum(a < hi and ids[a] < pad for a in at)
    lo, hi = lo + below * step, min(hi, lo + (below + 1) * step - 1)
    steps += 1
  return lo + sum(lo + lane < hi and ids[lo + lane] < pad
                  for lane in range(32)), steps


@pytest.mark.parametrize('n,owned', [
    (0, 0), (1, 0), (1, 1), (32, 32), (33, 0), (33, 33), (64, 17),
    (1025, 1024), (5000, 4999), (70_005, 70_000), (200_000, 3)])
def test_count_search_steps_follows_the_kernels_search(cs, n, owned):
  ids = np.full(n, np.iinfo(np.int32).max, np.int64)
  ids[:owned] = np.arange(owned) * 3
  count, steps = warp_search(ids)
  assert count == owned
  assert cs.count_search_steps(n, owned) == steps
  assert steps <= max(0, int(np.ceil(np.log(max(n, 1)) / np.log(32))))


def test_same_draws_hands_the_first_draw_to_the_second_build(cs):
  calls = []

  def draw(n, deg, rng):
    calls.append(n)
    return rng.integers(0, 100, n * deg), rng.standard_normal(n)

  plain = np.random.default_rng(0)
  before = plain.bit_generator.state
  want = draw(50, 3, plain)
  kept = {cs.SameDraws.key([50, 3], before): (want, plain.bit_generator.state)}
  want_next = plain.integers(0, 1 << 30, 4)
  memo = cs.SameDraws(draw, kept)
  del calls[:]
  for _ in range(3):            # every build takes the kept draw
    rng = np.random.default_rng(0)
    got = memo(50, 3, rng)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    # the generator is left where the draw left it
    assert np.array_equal(rng.integers(0, 1 << 30, 4), want_next)
    got[0][:] = -1              # a caller's change reaches no later call
  assert calls == []
  # another argument or generator state than the kept draw's fails
  for args, seed in (((51, 3), 0), ((50, 3), 1)):
    with pytest.raises(AssertionError, match='no draw kept'):
      memo(*args, np.random.default_rng(seed))
  assert calls == []


def test_same_draws_takes_a_draw_made_elsewhere(cs):
  rng = np.random.default_rng(0)
  before = rng.bit_generator.state
  out = (rng.integers(0, 9, 6),)
  kept = {cs.SameDraws.key([6, 2], before): (out, rng.bit_generator.state)}
  memo = cs.SameDraws(lambda *a: pytest.fail('drew'), kept)
  fresh = np.random.default_rng(0)
  got = memo(6, 2, fresh)
  assert np.array_equal(got[0], out[0])
  assert np.array_equal(fresh.integers(0, 9, 3), rng.integers(0, 9, 3))


@pytest.mark.parametrize('b,agree', [
    ([('k', 0.0, 5.0, 7), ('m', 1.0, 2.0, 7)], True),
    ([('m', 1.2, 2.2, 7), ('k', 0.4, 5.4, 9)], True),      # order, stream
    ([('k', 0.0, 5.9, 7), ('m', 1.0, 2.0, 7)], True),      # within 1 us
    ([('k', 0.0, 6.2, 7), ('m', 1.0, 2.0, 7)], False),
    ([('k', 0.0, 5.0, 7)], False),
    ([('k', 0.0, 5.0, 7), ('n', 1.0, 2.0, 7)], False),
], ids=['same', 'reordered', 'truncated', 'longer', 'fewer', 'renamed'])
def test_records_agree(cs, b, agree):
  a = ([('k', 0.0, 5.0, 7), ('m', 1.0, 2.0, 7)], (0.0, 9.0))
  assert cs.records_agree(a, (b, (0.0, 9.0))) is agree


def test_window_placement_reads_where_the_records_sit(cs):
  dev = [('void gather_rows_kernel<4>(...)', 1500.0, 1600.0, 7),
         ('void hop_slot_kernel(int const*)', 2500.0, 2550.0, 7),
         ('Memcpy HtoD', 1200.0, 1300.0, 8),
         ('void gather_rows_kernel<4>(...)', 3000.0, 3100.0, 7)]
  got = cs.window_placement((dev, (1000.0, 5000.0)))
  assert got == dict(window_ms=4.0, device_records=4, first_device_ms=0.2,
                     last_device_ms=2.1, streams={'7': 3, '8': 1},
                     port_kernels_ms=dict(gather_rows=[0.5, 2.0],
                                          sample_hop=[1.5, 1.5]))
  assert cs.window_placement(([], (1000.0, 5000.0))) == dict(
      window_ms=4.0, device_records=0)
  assert cs.window_placement(([], (None, None))) == {}
