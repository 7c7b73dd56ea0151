"""Build and load the host C++ runtime (the shared-memory ring).

Counterpart of ``graphlearn_tpu/utils/build.py``: ``csrc/shm_queue.cc``
(a byte-for-byte copy of the JAX package's ``csrc/shm_queue.cc``) is a
plain C interface compiled with ``g++`` at first use into
``build/torch_native/`` at the checkout root, named by a hash of the
source and the flags, and bound with ``ctypes``. The library is written
under a temporary name and renamed into place, so concurrent first uses
(test workers, sampling processes) never load a half-written file.
Nothing falls back: a missing or failing ``g++`` raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / 'csrc' / 'shm_queue.cc'
_BUILD = _PKG.parent / 'build' / 'torch_native'
_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17', '-pthread')

_lock = threading.Lock()
_lib = None


def native_lib_path() -> str:
  h = hashlib.sha256(_SRC.read_bytes())
  h.update(' '.join(_FLAGS).encode())
  return str(_BUILD / f'libglt_shmq-{h.hexdigest()[:16]}.so')


def build_native(force: bool = False) -> str:
  """Compile the ring into its library unless it is there; its path."""
  out = Path(native_lib_path())
  if out.exists() and not force:
    return str(out)
  gxx = shutil.which('g++')
  if gxx is None:
    raise RuntimeError('g++ not found: the shared-memory ring of '
                       'graphlearn_tpu_torch is built from source')
  _BUILD.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f'.tmp{os.getpid()}.{threading.get_ident()}')
  proc = subprocess.run([gxx, *_FLAGS, '-o', str(tmp), str(_SRC)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'g++ failed to build {_SRC.name} (exit '
                       f'{proc.returncode}):\n{proc.stderr}')
  os.replace(tmp, out)
  return str(out)


def load_native():
  """``ctypes`` handle to the ring library, building it if needed."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(build_native())
      lib.shmq_create.restype = ctypes.c_void_p
      lib.shmq_create.argtypes = [ctypes.c_uint64]
      lib.shmq_attach.restype = ctypes.c_void_p
      lib.shmq_attach.argtypes = [ctypes.c_int]
      lib.shmq_id.restype = ctypes.c_int
      lib.shmq_id.argtypes = [ctypes.c_void_p]
      lib.shmq_enqueue.restype = ctypes.c_int
      lib.shmq_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64]
      lib.shmq_next_size.restype = ctypes.c_int64
      lib.shmq_next_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
      lib.shmq_dequeue.restype = ctypes.c_int64
      lib.shmq_dequeue.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_long]
      lib.shmq_count.restype = ctypes.c_uint64
      lib.shmq_count.argtypes = [ctypes.c_void_p]
      lib.shmq_finish.restype = None
      lib.shmq_finish.argtypes = [ctypes.c_void_p]
      lib.shmq_reset_finished.restype = None
      lib.shmq_reset_finished.argtypes = [ctypes.c_void_p]
      lib.shmq_close.restype = None
      lib.shmq_close.argtypes = [ctypes.c_void_p]
      _lib = lib
  return _lib
