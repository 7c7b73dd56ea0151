"""Carry model weights and Adam state between flax/optax and torch.

A flax tree is ``{'params': {...}}`` of numpy arrays; a flax ``Dense``
kernel is ``[in, out]`` and a torch ``Linear`` weight ``[out, in]``.
optax's ``ScaleByAdamState(count, mu, nu)`` holds the moments as trees
of the same layout; torch's Adam keeps ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter.

A torch parameter ``a.b.weight`` is the flax leaf ``a/b/kernel`` with
its axes reversed (a ``Linear`` weight ``[out, in]`` is a ``Dense``
kernel ``[in, out]``, a ``Conv1d`` weight ``[out, in, k]`` a ``Conv``
kernel ``[k, in, out]``), an ``nn.Embedding`` weight is ``a/b/embedding``
as it stands, ``a.b.bias`` is ``a/b/bias`` and any other leaf (an
attention vector, a relation matrix, a prior) keeps its name and layout.
A module may rename its children (``flax_names``: ``GCNConv``'s ``lin``
is flax's auto-named ``Dense_0``), and a model its module path
(``model.flax_scope``): ``RGNN``'s segment convs, ``hetero{i}.convs.
{etype}``, are flax's auto-named ``SAGEConv_k`` / ``GATConv_k`` at the
top level. Without a model every leaf is carried with its module path
as it stands (GraphSAGE's ``conv{i}/lin_*``). Flax creates a parameter
only when its module runs, so a torch parameter with no flax leaf (a
conv no batch type reaches) is left out of the mapping both ways.
HGT's key biases get an exact 0 gradient in the port (``hgt._keys``), so
their Adam moments stay 0 where optax's hold rounding noise.
"""
import numpy as np
import torch
from torch import nn


def _flax_path(model, name):
  """``(flax path tuple, transposed)`` of the torch parameter ``name``:
  the one naming rule, read both ways."""
  *mods, leaf = name.split('.')
  transposed = leaf == 'weight'
  flax_leaf = 'kernel' if transposed else leaf
  if model is not None:
    renamed, owner = [], model
    for m in mods:
      renamed.append(getattr(owner, 'flax_names', {}).get(m, m))
      owner = owner.get_submodule(m)
    if transposed and isinstance(owner, nn.Embedding):
      flax_leaf, transposed = 'embedding', False
    mods = renamed
  scope = getattr(model, 'flax_scope', None)
  if scope is not None:
    mods = scope(mods)
  return tuple(mods) + (flax_leaf,), transposed


def _torch_names(tree, prefix=()):
  """The torch names of a flax tree's leaves, with no module renamed:
  the inverse of ``_flax_path`` without a model."""
  for key, sub in tree.items():
    if isinstance(sub, dict):
      yield from _torch_names(sub, prefix + (key,))
    else:
      yield '.'.join(prefix + ('weight' if key == 'kernel' else key,))


def _leaf(tree, path):
  for p in path:
    if not isinstance(tree, dict) or p not in tree:
      return None
    tree = tree[p]
  return tree


def params_from_flax(params, model=None) -> dict:
  """Flax params (numpy leaves) -> a torch ``state_dict`` of ``model``
  (default: every leaf of the tree, module paths kept)."""
  tree = params.get('params', params)
  names = (_torch_names(tree) if model is None else
           (n for n, _ in model.named_parameters()))
  sd = {}
  for name in names:
    path, transposed = _flax_path(model, name)
    arr = _leaf(tree, path)
    if arr is not None:
      sd[name] = _to_torch(arr, transposed)
  return sd


def _to_torch(arr, transposed):
  t = torch.as_tensor(np.array(arr, dtype=np.float32))
  return t.permute(*reversed(range(t.dim()))).contiguous() if transposed \
      else t


def params_to_flax(state_dict, model=None) -> dict:
  """The inverse: a torch ``state_dict`` -> ``{'params': ...}`` numpy."""
  tree = {}
  for name, t in state_dict.items():
    path, transposed = _flax_path(model, name)
    arr = t.detach().cpu().numpy()
    node = tree
    for p in path[:-1]:
      node = node.setdefault(p, {})
    node[path[-1]] = np.ascontiguousarray(arr.T) if transposed else arr
  return {'params': tree}


def adam_state_from_optax(optimizer, model, adam_state):
  """Load optax's ``ScaleByAdamState(count, mu, nu)`` (numpy leaves, the
  flax layout) into the torch Adam ``optimizer`` over ``model``'s
  parameters, so a JAX run resumes in the port mid-training."""
  count, mu, nu = adam_state
  mu_sd = params_from_flax(mu, model)
  nu_sd = params_from_flax(nu, model)
  step = float(np.asarray(count))
  # a capturable Adam keeps its count beside the parameter
  capturable = optimizer.defaults.get('capturable', False)
  for name, p in model.named_parameters():
    if name not in mu_sd:
      continue
    optimizer.state[p] = {
        'step': torch.tensor(step, dtype=torch.float32,
                             device=p.device if capturable else None),
        'exp_avg': mu_sd[name].to(p.device),
        'exp_avg_sq': nu_sd[name].to(p.device)}


def adam_state_to_optax(optimizer, model):
  """The inverse: ``(count, mu, nu)`` from the torch Adam ``optimizer``,
  ``mu`` and ``nu`` as ``{'params': ...}`` numpy trees (wrap them in
  ``optax.ScaleByAdamState``). optax steps every parameter, torch only
  those with a gradient: a parameter whose output no loss reads (a typed
  conv of a type the head never reads) stays behind, with zero moments,
  which is optax's state for it too. Parameters without Adam state are
  left out."""
  named = {n: p for n, p in model.named_parameters()
           if optimizer.state.get(p)}
  states = [optimizer.state[p] for p in named.values()]
  count = max(int(st['step']) for st in states)
  behind = [n for n, st in zip(named, states) if int(st['step']) != count
            and (bool(st['exp_avg'].any()) or bool(st['exp_avg_sq'].any()))]
  if behind:
    raise ValueError(f'parameters at different Adam steps: {behind}')
  mu = params_to_flax({n: st['exp_avg'] for n, st in zip(named, states)},
                      model)
  nu = params_to_flax({n: st['exp_avg_sq'] for n, st in zip(named, states)},
                      model)
  return count, mu, nu
