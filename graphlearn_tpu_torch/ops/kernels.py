"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to
``build/torch_kernels/`` at the checkout root, named by a hash of the
source and the flags, and are built at first use; ``build_all()`` starts
one ``nvcc`` per source at once. Nothing here runs at import time, and
nothing falls back: a missing compiler or a failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# kernel name -> (source file, C entry points -> (argtypes, restype)); a
# launching entry point returns its cudaError_t as an int
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SOURCES = {
    'gather_rows': ('gather_rows.cu', {
        'glt_gather_rows': ([_P, _P, _I, _P, _L, _L, _L, _I, _P], _I)}),
    'sample_hop': ('sample_hop.cu', {
        'glt_sample_hop': ([_P, _L, _P, _P, _L, _I, _P], _I)}),
    'sample_level': ('sample_level.cu', {
        'glt_sample_level_scratch': ([_L, _L], _L),
        'glt_sample_level': ([_P, _L, _P, _P, _L, _P, _L, _P, _L, _L, _P, _P,
                              _P, _P, _P, _I, _P], _I)}),
}

_libs = {}
_lock = threading.Lock()


def nvcc_path() -> str:
  cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
  if cand.exists():
    return str(cand)
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'of graphlearn_tpu_torch are built from source')
  return found


def _lib_path(name: str) -> Path:
  src = CSRC / SOURCES[name][0]
  h = hashlib.sha256(src.read_bytes())
  for extra in sorted(CSRC.glob('*.cuh')):
    h.update(extra.read_bytes())
  h.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build_all(names=None) -> dict:
  """Compile every missing library, one ``nvcc`` per source, all started
  together. Returns ``{name: seconds}`` for the ones built now; the
  compiler's report (registers, spills) is kept beside each library as
  ``.log``."""
  names = list(SOURCES) if names is None else list(names)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  t0 = time.perf_counter()
  for name in names:
    out = _lib_path(name)
    if out.exists():
      continue
    tmp = out.with_suffix(f'.tmp{os.getpid()}')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
           str(CSRC / SOURCES[name][0])]
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, out)
  took = {}
  errors = []
  for name, (proc, tmp, out) in procs.items():
    log, _ = proc.communicate()
    took[name] = time.perf_counter() - t0
    out.with_suffix('.log').write_text(log)
    if proc.returncode != 0:
      errors.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
      continue
    os.replace(tmp, out)
  if errors:
    raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(errors))
  return took


def build_log(name: str) -> str:
  path = _lib_path(name).with_suffix('.log')
  return path.read_text() if path.exists() else ''


def lib(name: str):
  """The loaded library of kernel ``name`` (built on first use)."""
  with _lock:
    if name not in _libs:
      path = _lib_path(name)
      if not path.exists():
        build_all([name])
      handle = ctypes.CDLL(str(path))
      for fn, (argtypes, restype) in SOURCES[name][1].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = restype
      _libs[name] = handle
    return _libs[name]


def check(err: int, what: str):
  if err != 0:
    raise RuntimeError(f'{what}: CUDA error {err} at launch')
