"""Host helpers and device resolution.

The port's counterpart of ``graphlearn_tpu/utils``: the CSR conversions
(``topo``), ``CheckpointManager`` (``checkpoint``), the dict, port and
module helpers (``common``), ``tensor``, ``units``, ``CastMixin``,
``Singleton`` and ``python_exit_status``, the fault registry
(``faults``: ``fault_point``, ``FaultError``) and ``trace``: the
profiler over ``torch.profiler`` (``profile_trace``, ``annotate``,
``maybe_start_trace``, ``device_op_ms``, ...), dispatch counting
(``count_dispatches``, ``record_dispatch``) and the event counters
(``counter_inc``, ``counters``, ...) and ``strict`` (``strict_enabled``,
``strict_guards``: ``GLT_STRICT``'s guard over the card's sync debug
mode). ``compat``, ``device`` and the JAX ``build`` are JAX-only.
"""
import torch

from .checkpoint import CheckpointManager
from .common import count_dict, get_free_port, load_module, merge_dict
from .exit_status import python_exit_status
from .faults import FaultError, fault_point
from .mixin import CastMixin
from .singleton import Singleton
from .strict import strict_enabled, strict_guards
from .tensor import convert_to_array, id2idx, squeeze_dict
from .topo import (coo_to_csc, coo_to_csr, csr_to_coo, csr_to_csc, ind2ptr,
                   ptr2ind)
from .trace import (DispatchCounter, annotate, count_dispatches,
                    counter_get, counter_inc, counters, device_op_ms,
                    device_program_ms, dispatch_snapshot,
                    maybe_start_trace, profile_trace, record_dispatch,
                    reset_counters, step_annotation, stop_trace,
                    wrap_dispatch)
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
