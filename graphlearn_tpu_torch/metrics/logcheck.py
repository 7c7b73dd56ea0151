"""Schema validation for the observability JSONL trails.

Two record kinds ride JSONL files: epoch flight records
(``GLT_RUN_LOG``, metrics/flight.py) and spans (``GLT_SPAN_LOG``,
metrics/spans.py). Postmortem tooling, the jq cookbook and the chaos
tests all key on their field names — a drifted field silently breaks
every consumer, so the schema is CHECKED, not just documented:

* :func:`validate_flight_record` / :func:`validate_span` return a list
  of problems for one parsed record (empty = valid);
* :func:`check_file` validates a whole JSONL file (mixed kinds are
  fine — the two recorders may share a file);
* the CLI (``python -m graphlearn_tpu_torch.metrics.logcheck
  [paths...]``) exits non-zero on any problem. With NO paths it
  self-checks: it validates a freshly-emitted flight record and span
  against the validators, so a recorder/validator drift shows in the
  change that introduces it.

The port's copy of ``graphlearn_tpu/metrics/logcheck.py``, with the same
schema: a record either package writes passes both checkers. Pure
stdlib, like the rest of the metrics package.
"""
import json
import os
import sys
from typing import List, Optional

# field name -> allowed types (a tuple feeds isinstance); Optional
# fields may also be null
_FLIGHT_REQUIRED = {
    'schema': (int,),
    'kind': (str,),
    'run_id': (str,),
    'emitter': (str,),
    'epoch': (int,),
    'steps': (int,),
    'completed': (bool,),
    'wall_s': (int, float),
    'feature': (dict,),
    'resilience': (dict,),
    'fault': (dict,),
    'programs': (dict,),
    'counters': (dict,),
    'config': (dict,),
    'config_fingerprint': (str,),
    'trace': (dict,),
    'time_unix': (int, float),
}
_FLIGHT_NULLABLE = {
    'dispatch': (dict,),
    'dispatch_total': (int,),
}
# fields later schema-1 writers added without a version bump: current
# records always carry them, but logs captured by earlier builds must
# still validate (present -> type-checked, absent -> fine)
_FLIGHT_OPTIONAL = {
    'storage': (dict,),
}

_SPAN_REQUIRED = {
    'schema': (int,),
    'kind': (str,),
    'name': (str,),
    'span': (str,),
    'trace': (str,),
    'run': (str,),
    'pid': (int,),
    't0_unix': (int, float),
    'dur_ms': (int, float),
}
_SPAN_NULLABLE = {
    'parent': (str,),
}
_SPAN_OPTIONAL = {
    'attrs': (dict,),
    'profile_key': (str,),
}


def _check_fields(rec: dict, required: dict, nullable: dict,
                  optional: dict, label: str) -> List[str]:
  problems = []
  for field, types in required.items():
    if field not in rec:
      problems.append(f'{label}: missing field {field!r}')
    elif not isinstance(rec[field], types):
      problems.append(
          f'{label}: field {field!r} has type '
          f'{type(rec[field]).__name__}, expected '
          f'{"/".join(t.__name__ for t in types)}')
  for field, types in nullable.items():
    if field in rec and rec[field] is not None and \
        not isinstance(rec[field], types):
      problems.append(
          f'{label}: field {field!r} must be null or '
          f'{"/".join(t.__name__ for t in types)}')
  for field, types in optional.items():
    if field in rec and not isinstance(rec[field], types):
      problems.append(
          f'{label}: field {field!r} must be '
          f'{"/".join(t.__name__ for t in types)}')
  return problems


def validate_flight_record(rec: dict, label: str = 'flight') -> List[str]:
  """Problems with one epoch flight record (empty list = valid)."""
  if rec.get('kind') != 'epoch':
    return [f'{label}: kind {rec.get("kind")!r} != "epoch"']
  return _check_fields(rec, _FLIGHT_REQUIRED, _FLIGHT_NULLABLE,
                       _FLIGHT_OPTIONAL, label)


def validate_span(rec: dict, label: str = 'span') -> List[str]:
  """Problems with one span record (empty list = valid)."""
  if rec.get('kind') != 'span':
    return [f'{label}: kind {rec.get("kind")!r} != "span"']
  problems = _check_fields(rec, _SPAN_REQUIRED, _SPAN_NULLABLE,
                           _SPAN_OPTIONAL, label)
  if isinstance(rec.get('dur_ms'), (int, float)) and rec['dur_ms'] < 0:
    problems.append(f'{label}: negative dur_ms {rec["dur_ms"]}')
  return problems


def validate_record(rec: dict, label: str = 'record') -> List[str]:
  kind = rec.get('kind')
  if kind == 'epoch':
    return validate_flight_record(rec, label)
  if kind == 'span':
    return validate_span(rec, label)
  return [f'{label}: unknown record kind {kind!r} '
          '(expected "epoch" or "span")']


def check_file(path: str) -> List[str]:
  """Validate every parseable line of a JSONL trail (unparseable lines
  are reported — the recorders never emit them; a torn final line from
  a crashed run is the one tolerated shape: reported as a note only
  when it is the last line)."""
  problems: List[str] = []
  with open(path, encoding='utf-8') as fh:
    lines = fh.read().splitlines()
  for i, line in enumerate(lines, 1):
    if not line.strip():
      continue
    label = f'{path}:{i}'
    try:
      rec = json.loads(line)
    except ValueError:
      if i == len(lines):
        continue   # torn final line: a mid-write crash, tolerated
      problems.append(f'{label}: unparseable JSON line')
      continue
    if not isinstance(rec, dict):
      problems.append(f'{label}: line is not a JSON object')
      continue
    problems.extend(validate_record(rec, label))
  return problems


def _self_check() -> List[str]:
  """Emit one flight record and one span through the REAL recorders
  into a temp file and validate them — recorder/validator drift fails
  the check in the change that introduces it."""
  import tempfile
  from . import flight, spans
  problems: List[str] = []
  with tempfile.TemporaryDirectory() as d:
    run_log = os.path.join(d, 'run.jsonl')
    span_log = os.path.join(d, 'spans.jsonl')
    old_run = os.environ.get(flight.ENV_VAR)
    old_span = os.environ.get(spans.ENV_LOG)
    os.environ[flight.ENV_VAR] = run_log
    os.environ[spans.ENV_LOG] = span_log
    try:
      tok = flight.epoch_begin()
      flight.epoch_end(tok, emitter='logcheck', epoch=0, steps=1,
                       config={'self_check': True})
      with spans.span('epoch.run', emitter='logcheck'):
        pass
    finally:
      for var, old in ((flight.ENV_VAR, old_run),
                       (spans.ENV_LOG, old_span)):
        if old is None:
          os.environ.pop(var, None)
        else:
          os.environ[var] = old
    for path in (run_log, span_log):
      if not os.path.exists(path):
        problems.append(f'self-check: recorder wrote nothing to {path}')
        continue
      problems.extend(check_file(path))
  return problems


def main(argv: Optional[List[str]] = None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  paths = [p for p in argv if p not in ('-q', '--quiet')]
  quiet = len(paths) != len(argv)
  if paths:
    problems = []
    for p in paths:
      if not os.path.exists(p):
        problems.append(f'{p}: no such file')
        continue
      problems.extend(check_file(p))
  else:
    problems = _self_check()
  for msg in problems:
    print(msg, file=sys.stderr)
  if not quiet:
    what = ', '.join(paths) if paths else 'recorder self-check'
    print(f'logcheck: {len(problems)} problem(s) ({what})')
  return 1 if problems else 0


if __name__ == '__main__':
  sys.exit(main())
