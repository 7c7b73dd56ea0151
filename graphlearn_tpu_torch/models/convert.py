"""Carry GraphSAGE weights and Adam state between flax/optax and torch.

The flax tree is ``{'params': {'conv{i}': {'lin_self': {'kernel',
'bias'}, 'lin_nbr': {'kernel'}}}}`` of numpy arrays; a flax ``Dense``
kernel is ``[in, out]`` and a torch ``Linear`` weight ``[out, in]``.
optax's ``ScaleByAdamState(count, mu, nu)`` holds the moments as trees
of the same layout; torch's Adam keeps ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter. Both map by the same ``conv{i}.lin_*``
names.
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


def adam_state_from_optax(optimizer, model, adam_state):
  """Load optax's ``ScaleByAdamState(count, mu, nu)`` (numpy leaves, the
  flax layout) into the torch Adam ``optimizer`` over ``model``'s
  parameters, so a JAX run resumes in the port mid-training."""
  count, mu, nu = adam_state
  mu_sd, nu_sd = params_from_flax(mu), params_from_flax(nu)
  step = float(np.asarray(count))
  # a capturable Adam keeps its count beside the parameter
  capturable = optimizer.defaults.get('capturable', False)
  for name, p in model.named_parameters():
    optimizer.state[p] = {
        'step': torch.tensor(step, dtype=torch.float32,
                             device=p.device if capturable else None),
        'exp_avg': mu_sd[name].to(p.device),
        'exp_avg_sq': nu_sd[name].to(p.device)}


def adam_state_to_optax(optimizer, model):
  """The inverse: ``(count, mu, nu)`` from the torch Adam ``optimizer``,
  ``mu`` and ``nu`` as ``{'params': ...}`` numpy trees (wrap them in
  ``optax.ScaleByAdamState``)."""
  named = dict(model.named_parameters())
  states = [optimizer.state[p] for p in named.values()]
  counts = {int(st['step']) for st in states}
  if len(counts) != 1:
    raise ValueError(f'parameters at different Adam steps: {counts}')
  mu = params_to_flax({n: st['exp_avg'] for n, st in zip(named, states)})
  nu = params_to_flax({n: st['exp_avg_sq'] for n, st in zip(named, states)})
  return counts.pop(), mu, nu
