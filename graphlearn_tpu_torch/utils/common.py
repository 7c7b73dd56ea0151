"""Dict merge/count helpers, a free port, and loading a source file as a
module (the port's copy of ``graphlearn_tpu/utils/common.py``)."""
import socket
from typing import Dict, List

import numpy as np


def merge_dict(in_dict: Dict, out_dict: Dict[object, List]
               ) -> Dict[object, List]:
  """Append each value of ``in_dict`` onto the list at the same key."""
  for k, v in in_dict.items():
    out_dict.setdefault(k, []).append(v)
  return out_dict


def count_dict(in_dict: Dict, out_dict: Dict[object, List],
               expand: int) -> Dict:
  """Record per-key cumulative counts, padding absent keys with the last
  value."""
  for vals in out_dict.values():
    while len(vals) < expand - 1:
      vals.append(vals[-1] if vals else 0)
  for k, v in in_dict.items():
    n = int(np.asarray(v).shape[0]) if v is not None else 0
    out_dict.setdefault(k, [0] * (expand - 1))
    out_dict[k].append(n)
  for vals in out_dict.values():
    while len(vals) < expand:
      vals.append(vals[-1] if vals else 0)
  return out_dict


def get_free_port(host: str = 'localhost') -> int:
  """A TCP port on ``host`` that was free when asked (a rendezvous
  address for ``torch.distributed``)."""
  s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
  try:
    s.bind((host, 0))
    return s.getsockname()[1]
  finally:
    s.close()


def load_module(path, name=None):
  """Import a source FILE as a module object, so examples and benchmarks
  share helpers from sibling scripts without packaging them."""
  import importlib.util
  import os
  name = name or '_glt_mod_' + \
      os.path.splitext(os.path.basename(path))[0]
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod
