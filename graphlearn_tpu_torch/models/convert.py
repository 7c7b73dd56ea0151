"""Carry GraphSAGE weights between the flax parameter tree and torch.

The flax tree is ``{'params': {'conv{i}': {'lin_self': {'kernel',
'bias'}, 'lin_nbr': {'kernel'}}}}`` of numpy arrays; a flax ``Dense``
kernel is ``[in, out]`` and a torch ``Linear`` weight ``[out, in]``.
"""
import numpy as np
import torch


def params_from_flax(params) -> dict:
  """Flax GraphSAGE params (numpy leaves) -> a torch ``state_dict``."""
  tree = params.get('params', params)
  sd = {}
  for conv, layers in tree.items():
    for lin, leaves in layers.items():
      for leaf, arr in leaves.items():
        t = torch.as_tensor(np.array(arr, dtype=np.float32))
        if leaf == 'kernel':
          sd[f'{conv}.{lin}.weight'] = t.t().contiguous()
        elif leaf == 'bias':
          sd[f'{conv}.{lin}.bias'] = t
        else:
          raise ValueError(f'unexpected flax leaf {conv}/{lin}/{leaf}')
  return sd


def params_to_flax(state_dict) -> dict:
  """The inverse: a torch ``state_dict`` -> ``{'params': ...}`` numpy."""
  tree = {}
  for name, t in state_dict.items():
    conv, lin, leaf = name.split('.')
    arr = t.detach().cpu().numpy()
    node = tree.setdefault(conv, {}).setdefault(lin, {})
    if leaf == 'weight':
      node['kernel'] = np.ascontiguousarray(arr.T)
    else:
      node['bias'] = arr
  return {'params': tree}
