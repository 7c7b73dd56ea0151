"""Host rows the card reads in place: page-locked, mapped host memory.

The hot/cold gather (``gather.gather_rows_unified``) reads the cold rows
of a feature table straight from host memory over UVA, as the
reference's ``unified_tensor.cu`` does. For that a CPU tensor is
registered with CUDA (``cudaHostRegister`` with
``cudaHostRegisterMapped``, and ``cudaHostRegisterReadOnly`` where the
card supports it) through the ``gather_unified`` library, and the kernel
is handed the pointer ``cudaHostGetDevicePointer`` gives for it (on some
systems it is not the host pointer). ``tensor.pin_memory()`` is not used:
its caching allocator rounds a large tail up to a power of two.

CUDA keeps one table of registered ranges per process and refuses a
range that overlaps one already registered, so this module keeps the
process's registrations in one table too: registering the same tensor
again (a store rebuilt in the same process from its IPC handle) counts a
reference, and the range is unregistered when the last one is released.
A release first waits for the last launch that read the range (an event
each launch records), so a tail is never freed under a pending kernel.

:func:`empty` allocates a CPU tensor on pages of its own (an anonymous
``mmap``), so no other allocation shares a page with a registered range.
"""
import ctypes
import mmap
import threading

import torch

from . import kernels

_lock = threading.Lock()
_registered = {}   # host data pointer -> _Registration


class _Registration:
  __slots__ = ('tensor', 'nbytes', 'device_ptr', 'device', 'refs',
               'last_use', 'read_only')

  def __init__(self, tensor, nbytes, device_ptr, device, read_only):
    self.tensor = tensor          # keeps the host memory alive
    self.nbytes = nbytes
    self.device_ptr = device_ptr
    self.device = device
    self.refs = 1
    self.last_use = None          # CUDA event after the last reading launch
    self.read_only = read_only


def empty(shape, dtype) -> torch.Tensor:
  """A contiguous CPU tensor on pages of its own (anonymous ``mmap``;
  the tensor keeps the mapping alive)."""
  numel = 1
  for s in shape:
    numel *= int(s)
  itemsize = torch.empty((), dtype=dtype).element_size()
  nbytes = max(numel * itemsize, 1)
  buf = mmap.mmap(-1, nbytes)
  return torch.frombuffer(buf, dtype=torch.uint8)[:numel * itemsize].view(
      dtype).view(tuple(shape))


def register(tensor: torch.Tensor, device: torch.device) -> None:
  """Page-lock and map a contiguous CPU ``tensor`` for ``device``'s
  kernels (a second registration of the same tensor counts a reference).
  Raises on a CUDA error, a range that overlaps another registered one,
  or an empty tensor."""
  if tensor.device.type != 'cpu' or not tensor.is_contiguous():
    raise ValueError('only a contiguous CPU tensor can be mapped')
  nbytes = tensor.numel() * tensor.element_size()
  if nbytes == 0:
    raise ValueError('an empty tensor has nothing to map')
  ptr = tensor.data_ptr()
  with _lock:
    reg = _registered.get(ptr)
    if reg is not None:
      if reg.nbytes != nbytes or (reg.device.index or 0) != (device.index or 0):
        raise ValueError('another range at this address is already mapped')
      reg.refs += 1
      return
    for other in _registered.values():
      o = other.tensor.data_ptr()
      if ptr < o + other.nbytes and o < ptr + nbytes:
        raise ValueError('the range overlaps a mapped one')
    out = ctypes.c_void_p()
    read_only = ctypes.c_int()
    err = kernels.lib('gather_unified').glt_host_register(
        ptr, nbytes, device.index or 0, ctypes.addressof(out),
        ctypes.addressof(read_only))
    kernels.check(err, 'cudaHostRegister')
    _registered[ptr] = _Registration(tensor, nbytes, out.value, device,
                                     bool(read_only.value))


def release(tensor: torch.Tensor) -> None:
  """Drop one reference to ``tensor``'s registration; at the last, wait
  for the last launch that read it, then unregister."""
  with _lock:
    reg = _registered.get(tensor.data_ptr())
    if reg is None:
      return
    reg.refs -= 1
    if reg.refs:
      return
    del _registered[tensor.data_ptr()]
  if reg.last_use is not None:
    reg.last_use.synchronize()
  err = kernels.lib('gather_unified').glt_host_unregister(
      reg.tensor.data_ptr(), reg.device.index or 0)
  kernels.check(err, 'cudaHostUnregister')


def lookup(tensor: torch.Tensor) -> _Registration:
  """The registration whose range holds ``tensor`` (a registered tensor
  or a contiguous view into one); raises if there is none."""
  ptr = tensor.data_ptr()
  nbytes = tensor.numel() * tensor.element_size()
  with _lock:
    reg = _registered.get(ptr)
    if reg is None:
      for other in _registered.values():
        o = other.tensor.data_ptr()
        if o <= ptr and ptr + nbytes <= o + other.nbytes:
          reg = other
          break
  if reg is None:
    raise ValueError('the host rows are not mapped: register them with '
                     'ops.mapped.register first')
  return reg


def device_pointer(tensor: torch.Tensor) -> int:
  """The card's address of ``tensor``'s first byte (through its range's
  ``cudaHostGetDevicePointer``)."""
  reg = lookup(tensor)
  return reg.device_ptr + (tensor.data_ptr() - reg.tensor.data_ptr())


def mark_used(tensor: torch.Tensor, stream) -> None:
  """Record on ``stream`` that a launch just queued reads ``tensor``'s
  range: its release waits for this point of the stream."""
  reg = lookup(tensor)
  if reg.last_use is None:
    reg.last_use = torch.cuda.Event()
  reg.last_use.record(stream)


def is_mapped(tensor: torch.Tensor) -> bool:
  with _lock:
    return tensor.data_ptr() in _registered
