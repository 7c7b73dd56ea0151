"""Host helpers and device resolution.

The port's counterpart of ``graphlearn_tpu/utils``: the CSR conversions
(``topo``), ``CheckpointManager`` (``checkpoint``), the dict, port and
module helpers (``common``), ``tensor``, ``units``, ``CastMixin``,
``Singleton`` and ``python_exit_status``, the fault registry
(``faults``: ``fault_point``, ``FaultError``) and the event counters of
``trace`` (``counter_inc``, ``counter_get``, ``counters``,
``reset_counters``). ``compat``, ``device`` and ``build`` are JAX-only;
``strict`` and the profiler half of ``trace`` wait for the tracing
slice.
"""
import torch

from .checkpoint import CheckpointManager
from .common import count_dict, get_free_port, load_module, merge_dict
from .exit_status import python_exit_status
from .faults import FaultError, fault_point
from .mixin import CastMixin
from .singleton import Singleton
from .tensor import convert_to_array, id2idx, squeeze_dict
from .topo import (coo_to_csc, coo_to_csr, csr_to_coo, csr_to_csc, ind2ptr,
                   ptr2ind)
from .trace import counter_get, counter_inc, counters, reset_counters
from .units import format_size, parse_size


def resolve_device(device=None) -> torch.device:
  """``None`` means the card. Without one, raise instead of carrying on
  on the CPU: a caller that wants the CPU says ``device='cpu'``."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'graphlearn_tpu_torch runs on a CUDA device by default and none '
          "is available; pass device='cpu' to run on the CPU explicitly")
    return torch.device('cuda')
  return torch.device(device)
