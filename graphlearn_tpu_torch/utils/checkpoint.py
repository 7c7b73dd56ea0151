"""Checkpoint and resume of a training state and a loader's position.

The port's counterpart of ``graphlearn_tpu/utils/checkpoint.py``
(``CheckpointManager`` over orbax). Here one step is one directory
``<directory>/<step>/`` holding ``state.pt`` (``torch.save`` of the
state's ``state_dict``s: a model's, Adam's, a ``TrainState``'s, or a
dict or tuple of them, with tensors, numpy arrays and numbers as they
are) and ``meta.json`` (the step, the caller's ``extra`` and the
loader's ``state_dict``: its shuffle stream, the batches consumed in the
epoch and the sampler's key and counter, so a restore resumes at the
exact next batch). A step is written under a temporary name in the same
directory and renamed into place, so a crash mid-save never leaves a
step that looks complete. ``max_to_keep`` newest steps stay. A
checkpoint is read back only by the package that wrote it.
"""
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch


def _jsonify(obj):
  """numpy scalars and arrays inside rng state dicts -> JSON-able."""
  if isinstance(obj, dict):
    return {k: _jsonify(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_jsonify(v) for v in obj]
  if isinstance(obj, np.ndarray):
    return {'__ndarray__': obj.tolist(), 'dtype': str(obj.dtype)}
  if isinstance(obj, np.generic):
    return obj.item()
  return obj


def _dejsonify(obj):
  if isinstance(obj, dict):
    if '__ndarray__' in obj:
      return np.asarray(obj['__ndarray__'], dtype=obj['dtype'])
    return {k: _dejsonify(v) for k, v in obj.items()}
  if isinstance(obj, list):
    return [_dejsonify(v) for v in obj]
  return obj


def _state_of(obj):
  """What ``torch.save`` writes for ``obj``: a module's or optimizer's
  ``state_dict``, a named tuple or dict or list of those by field, a
  tensor or array or number as it is."""
  if hasattr(obj, 'state_dict') and hasattr(obj, 'load_state_dict'):
    return obj.state_dict()
  if isinstance(obj, tuple) and hasattr(obj, '_fields'):
    return {f: _state_of(getattr(obj, f)) for f in obj._fields}
  if isinstance(obj, dict):
    return {k: _state_of(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_state_of(v) for v in obj]
  return obj


def _load_into(template, saved):
  """``template`` with ``saved`` loaded: modules and optimizers in place,
  named tuples, dicts and lists rebuilt, tensors on the template's
  device, the rest replaced."""
  if hasattr(template, 'state_dict') and hasattr(template,
                                                  'load_state_dict'):
    template.load_state_dict(saved)
    return template
  if isinstance(template, tuple) and hasattr(template, '_fields'):
    return type(template)(*[_load_into(getattr(template, f), saved[f])
                            for f in template._fields])
  if isinstance(template, dict):
    return {k: _load_into(v, saved[k]) for k, v in template.items()}
  if isinstance(template, (list, tuple)):
    return type(template)(_load_into(t, s) for t, s in zip(template, saved))
  if torch.is_tensor(template):
    return torch.as_tensor(saved).to(template.device, template.dtype)
  return saved


class CheckpointManager:
  """Step-indexed checkpoints under one directory."""

  def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    os.makedirs(self.directory, exist_ok=True)

  def _step_dir(self, step: int) -> str:
    return os.path.join(self.directory, str(int(step)))

  def save(self, step: int, state: Any, loader=None, extra: Any = None):
    """Write ``state`` (and the loader's position and ``extra`` as JSON)
    at ``step``."""
    meta = {'step': int(step), 'extra': _jsonify(extra)}
    if loader is not None:
      meta['loader'] = _jsonify(loader.state_dict())
    tmp = tempfile.mkdtemp(prefix=f'.tmp-{int(step)}-', dir=self.directory)
    try:
      torch.save(_state_of(state), os.path.join(tmp, 'state.pt'))
      with open(os.path.join(tmp, 'meta.json'), 'w') as fh:
        json.dump(meta, fh)
      final = self._step_dir(step)
      if os.path.isdir(final):
        shutil.rmtree(final)
      os.replace(tmp, final)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    if self.max_to_keep is not None:
      for old in self.all_steps()[:-self.max_to_keep]:
        shutil.rmtree(self._step_dir(old), ignore_errors=True)

  def all_steps(self):
    return sorted(int(n) for n in os.listdir(self.directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(self.directory, n, 'meta.json')))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def restore(self, state_template: Any, step: Optional[int] = None,
              loader=None):
    """Load ``step`` (default: the newest) into ``state_template``.
    Returns ``(state, extra)``; a given ``loader``'s position is restored
    in place."""
    if step is None:
      step = self.latest_step()
    if step is None:
      raise FileNotFoundError(f'no checkpoints in {self.directory}')
    d = self._step_dir(step)
    saved = torch.load(os.path.join(d, 'state.pt'), weights_only=False)
    with open(os.path.join(d, 'meta.json')) as fh:
      meta = json.load(fh)
    if loader is not None and 'loader' in meta:
      loader.load_state_dict(_dejsonify(meta['loader']))
    return _load_into(state_template, saved), _dejsonify(meta.get('extra'))

  def close(self):
    """Nothing is held open between calls (orbax's manager is)."""
