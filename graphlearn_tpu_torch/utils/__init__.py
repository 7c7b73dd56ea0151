"""Host helpers and device resolution.

The port's counterpart of ``graphlearn_tpu/utils``: the CSR conversions
(``topo``), ``CheckpointManager`` (``checkpoint``), the dict, port and
module helpers (``common``), ``tensor``, ``units``, ``CastMixin``,
``Singleton`` and ``python_exit_status``. ``compat``, ``device`` and
``build`` are JAX-only; ``strict``, ``faults`` and ``trace`` wait for the
tracing slice.
"""
import torch

from .checkpoint import CheckpointManager
from .common import count_dict, get_free_port, load_module, merge_dict
from .exit_status import python_exit_status
from .mixin import CastMixin
from .singleton import Singleton
from .tensor import convert_to_array, id2idx, squeeze_dict
from .topo import (coo_to_csc, coo_to_csr, csr_to_coo, csr_to_csc, ind2ptr,
                   ptr2ind)
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
