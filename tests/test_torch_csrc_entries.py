"""The C entries of the port's CUDA sources restore the caller's card.

PyTorch's unindexed ``'cuda'`` device is the calling thread's current one.
An ``extern "C"`` entry that sets the card it launches on or configures
(``cudaSetDevice``) and returns with it still set moves the caller's next
``'cuda'`` tensor onto that card: a fault that only shows with two cards or
more, so no card test here can see it. This test reads the sources (no
compiler, no card): every entry of ``graphlearn_tpu_torch/csrc/*.cu`` that
calls ``cudaSetDevice`` must first declare the one shared guard,
``glt::DeviceRestore`` of ``csrc/device_restore.cuh``, and no source may
keep a copy of its own. ``tests/test_torch_cuda.py::
test_kernel_entries_leave_the_current_device`` checks the same on the
card.
"""
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / 'graphlearn_tpu_torch' / 'csrc'
SOURCES = sorted(p.name for p in CSRC.glob('*.cu'))
GUARD = re.compile(r'\bglt::DeviceRestore\s+\w+\s*;')


def strip_comments(text: str) -> str:
  text = re.sub(r'/\*.*?\*/', ' ', text, flags=re.S)
  return re.sub(r'//[^\n]*', '', text)


def c_entries(text: str) -> dict:
  """``{name: body}`` of every ``extern "C"`` function defined in
  ``text`` (comments stripped), the body between its outer braces."""
  out = {}
  for m in re.finditer(r'extern\s+"C"\s+[^;{(]*?\b(\w+)\s*\(', text):
    # skip to the end of the parameter list; a declaration ends in ;
    depth, j = 1, m.end()
    while depth:
      depth += {'(': 1, ')': -1}.get(text[j], 0)
      j += 1
    rest = text[j:].lstrip()
    if not rest.startswith('{'):
      continue
    start = text.index('{', j)
    depth, k = 1, start + 1
    while depth:
      depth += {'{': 1, '}': -1}.get(text[k], 0)
      k += 1
    out[m.group(1)] = text[start + 1:k - 1]
  return out


def unguarded(body: str) -> bool:
  """Whether ``body`` calls cudaSetDevice before declaring the guard."""
  first_set = body.find('cudaSetDevice(')
  if first_set < 0:
    return False
  guard = GUARD.search(body)
  return guard is None or guard.start() > first_set


@pytest.mark.parametrize('source', SOURCES)
def test_every_entry_that_sets_a_card_restores_the_callers(source):
  text = strip_comments((CSRC / source).read_text())
  entries = c_entries(text)
  assert entries, f'{source}: no extern "C" entry found'
  setting = [n for n, b in entries.items() if 'cudaSetDevice(' in b]
  bad = [n for n in setting if unguarded(entries[n])]
  assert not bad, (f'{source}: {bad} call cudaSetDevice without first '
                   'declaring glt::DeviceRestore (csrc/device_restore.cuh)')
  if setting:
    assert '#include "device_restore.cuh"' in text, source
  assert not re.search(r'\bstruct\s+DeviceRestore\b', text), (
      f'{source} keeps its own DeviceRestore; use device_restore.cuh')


def test_the_guard_is_defined_once_and_restores():
  text = strip_comments((CSRC / 'device_restore.cuh').read_text())
  assert len(re.findall(r'\bstruct\s+DeviceRestore\b', text)) == 1
  ctor = re.search(r'DeviceRestore\(\)\s*\{([^}]*)\}', text).group(1)
  dtor = re.search(r'~DeviceRestore\(\)\s*\{([^}]*)\}', text).group(1)
  assert 'cudaGetDevice(' in ctor and 'cudaSetDevice(' in dtor


@pytest.mark.parametrize('body,bad', [
    ('  cudaError_t err = cudaSetDevice(device);\n  return err;', True),
    ('  cudaError_t err = cudaSetDevice(device);\n'
     '  glt::DeviceRestore restore;\n  return err;', True),
    ('  glt::DeviceRestore restore;\n'
     '  cudaError_t err = cudaSetDevice(device);\n  return err;', False),
    ('  return cudaGetLastError();', False)])
def test_the_check_tells_a_guarded_entry_from_an_unguarded_one(body, bad):
  text = f'extern "C" int glt_x(int device, void* stream) {{\n{body}\n}}\n'
  entries = c_entries(strip_comments(text))
  assert list(entries) == ['glt_x']
  assert unguarded(entries['glt_x']) == bad
