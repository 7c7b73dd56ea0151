"""``SamplerOutput`` <-> flat ``SampleMessage`` conversion.

Counterpart of ``graphlearn_tpu/distributed/message.py``: a sampled
batch crosses channels and the server-client wire as a flat dict of
numpy arrays with '#' control keys, JAX's keys and ``#META.`` convention
exactly (padding kept), so a message built by either package reads in
the other.

On a card, the batch's tensors reach the host in ONE device-to-host copy
per batch: they are packed into one byte buffer on the device and copied
once into pinned memory, and the message's arrays view that copy
(:func:`to_host`). :func:`message_to_data` uploads one array at a time
from the deserialized views.
"""
import numpy as np
import torch

from ..loader.transform import Data, HeteroData
from ..typing import as_str, to_edge_type

META_PREFIX = '#META.'


def _leaf(v):
  """A tensor (0-d kept) for a tensor, a Python number or a numpy array;
  None for what cannot ride a channel."""
  if torch.is_tensor(v):
    return v.float() if v.dtype == torch.bfloat16 else v
  arr = np.asarray(v)
  if arr.dtype == object:    # nested containers can't ride the channel
    return None
  if not arr.flags.c_contiguous:
    arr = np.ascontiguousarray(arr)
  return torch.from_numpy(arr)


def to_host(tensors: dict) -> dict:
  """``{key: tensor}`` -> ``{key: numpy array}``. CPU tensors are viewed
  as they are; the device tensors are packed into one byte buffer on
  their device (each at an 8-byte aligned offset) and brought to the host
  in one copy into pinned memory."""
  out, dev = {}, []
  for k, t in tensors.items():
    if t.device.type == 'cpu':
      out[k] = t.numpy()
    else:
      dev.append((k, t.contiguous()))
  if not dev:
    return out
  offs, total = [], 0
  for _, t in dev:
    offs.append(total)
    total += -(-t.numel() * t.element_size() // 8) * 8
  device = dev[0][1].device
  packed = torch.empty(max(total, 8), dtype=torch.uint8, device=device)
  for (_, t), off in zip(dev, offs):
    n = t.numel() * t.element_size()
    if n:
      packed[off:off + n].copy_(t.reshape(-1).view(torch.uint8))
  host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
  host.copy_(packed, non_blocking=True)
  torch.cuda.current_stream(device).synchronize()
  flat = host.numpy()
  for (k, t), off in zip(dev, offs):
    n = t.numel() * t.element_size()
    dtype = torch.empty((), dtype=t.dtype).numpy().dtype
    out[k] = flat[off:off + n].view(dtype).reshape(tuple(t.shape))
  return out


def _hop_counts_on(vals, device):
  """Per-hop counts as one ``[n]`` int64 tensor on ``device`` (JAX:
  ``np.asarray([np.asarray(v) for v in vals])``, int32 there)."""
  parts = [torch.as_tensor(v).reshape(()).to(device) if torch.is_tensor(v)
           else torch.tensor(int(v), device=device) for v in vals]
  return torch.stack(parts) if parts else torch.zeros((0,), device=device)


def _meta(metadata: dict, t: dict):
  for k, v in metadata.items():
    leaf = _leaf(v)
    if leaf is not None:
      t[META_PREFIX + k] = leaf


def output_to_message(out, x=None, y=None) -> dict:
  """Flatten a (homogeneous) ``SamplerOutput`` and optional collected
  features ``x`` and labels ``y`` into a message of numpy arrays."""
  return to_host(output_tensors(out, x, y))


def output_tensors(out, x=None, y=None) -> dict:
  """:func:`output_to_message`'s keys, as tensors where the batch lies
  (a block producer stacks K batches before the one host copy)."""
  dev = out.node.device if torch.is_tensor(out.node) else None
  t = {
      'node': _leaf(out.node),
      'num_nodes': _leaf(out.num_nodes),
      'row': _leaf(out.row),
      'col': _leaf(out.col),
      'edge_mask': _leaf(out.edge_mask),
  }
  if out.edge is not None:
    t['edge'] = _leaf(out.edge)
  if out.batch is not None:
    t['batch'] = _leaf(out.batch)
  if out.batch_size is not None:
    t['#META.batch_size'] = _leaf(out.batch_size)
  if out.num_sampled_nodes is not None:
    t['num_sampled_nodes'] = _hop_counts_on(out.num_sampled_nodes,
                                            dev or 'cpu').to(torch.int32)
  if out.num_sampled_edges is not None:
    t['num_sampled_edges'] = _hop_counts_on(out.num_sampled_edges,
                                            dev or 'cpu').to(torch.int32)
  if x is not None:
    t['x'] = _leaf(x)
  if y is not None:
    t['y'] = _leaf(y)
  _meta(out.metadata, t)
  return t


def _et_key(et) -> str:
  return as_str(tuple(et))


def hetero_output_to_message(out, x_dict=None, y_dict=None) -> dict:
  """Flatten a ``HeteroSamplerOutput`` and optional typed features and
  labels. Typed payloads use dotted keys (``node.paper``,
  ``row.paper__cites__paper``); ``#META.hetero`` marks the message so
  :func:`message_to_data` rebuilds a ``HeteroData``. Node and edge type
  names must not contain '.' or '__'."""
  return to_host(hetero_output_tensors(out, x_dict, y_dict))


def hetero_output_tensors(out, x_dict=None, y_dict=None) -> dict:
  """:func:`hetero_output_to_message`'s keys, as tensors where the batch
  lies."""
  t = {'#META.hetero': torch.tensor(1)}
  for nt, v in out.node.items():
    t[f'node.{nt}'] = _leaf(v)
    t[f'num_nodes.{nt}'] = _leaf(out.num_nodes[nt])
  for et, v in out.row.items():
    k = _et_key(et)
    t[f'row.{k}'] = _leaf(v)
    t[f'col.{k}'] = _leaf(out.col[et])
    t[f'edge_mask.{k}'] = _leaf(out.edge_mask[et])
    if out.edge is not None and et in out.edge:
      t[f'edge.{k}'] = _leaf(out.edge[et])
    if out.num_sampled_edges is not None and et in out.num_sampled_edges:
      t[f'num_sampled_edges.{k}'] = _hop_counts_on(
          out.num_sampled_edges[et], v.device).to(torch.int32)
  if out.batch is not None:
    for nt, v in out.batch.items():
      t[f'batch.{nt}'] = _leaf(v)
  if out.num_sampled_nodes is not None:
    for nt, v in out.num_sampled_nodes.items():
      dev = out.node[nt].device if nt in out.node else 'cpu'
      t[f'num_sampled_nodes.{nt}'] = _hop_counts_on(v, dev).to(torch.int32)
  if out.batch_size is not None:
    t['#META.batch_size'] = _leaf(out.batch_size)
  if out.input_type is not None:
    t['#META.input_type'] = torch.from_numpy(np.frombuffer(
        as_str(out.input_type).encode(), dtype=np.uint8).copy())
  for nt, v in (x_dict or {}).items():
    t[f'x.{nt}'] = _leaf(v)
  for nt, v in (y_dict or {}).items():
    t[f'y.{nt}'] = _leaf(v)
  _meta(out.metadata, t)
  return t


def _hetero_message_to_data(msg: dict, conv):
  """``SampleMessage`` -> ``loader.HeteroData`` (keys as
  :func:`hetero_output_to_message`'s)."""
  def group(prefix, et_keyed=False):
    d = {}
    for k, v in msg.items():
      if not k.startswith(prefix + '.'):
        continue
      name = k[len(prefix) + 1:]
      d[to_edge_type(name) if et_keyed else name] = v
    return d

  node = {nt: conv(v) for nt, v in group('node').items()}
  num_nodes = {nt: int(np.asarray(v).reshape(-1)[0])
               for nt, v in group('num_nodes').items() if '__' not in nt}
  rows = group('row', et_keyed=True)
  cols = group('col', et_keyed=True)
  ei = {}
  for et, r in rows.items():
    r2, c2 = conv(r), conv(cols[et])
    ei[et] = torch.stack([r2, c2]) if torch.is_tensor(r2) else \
        np.stack([r2, c2])
  em = {et: conv(v) for et, v in group('edge_mask', True).items()}
  eids = {et: conv(v) for et, v in group('edge', True).items()} or None
  x = {nt: conv(v) for nt, v in group('x').items()} or None
  y = {nt: conv(v) for nt, v in group('y').items()} or None
  batch = {nt: conv(v) for nt, v in group('batch').items()} or None
  nsn = {nt: v for nt, v in group('num_sampled_nodes').items()
         if '__' not in nt} or None
  nse = group('num_sampled_edges', et_keyed=True) or None
  metadata = {k[len(META_PREFIX):]: v for k, v in msg.items()
              if k.startswith(META_PREFIX) and
              k not in ('#META.batch_size', '#META.hetero',
                        '#META.input_type')}
  if '#META.input_type' in msg:
    metadata['input_type'] = bytes(
        np.asarray(msg['#META.input_type'])).decode()
  return HeteroData(
      node=node, num_nodes=num_nodes, edge_index=ei, edge_mask=em,
      x=x, y=y, edge_ids=eids, batch=batch,
      batch_size=(int(np.asarray(msg['#META.batch_size']).reshape(-1)[0])
                  if '#META.batch_size' in msg else None),
      num_sampled_nodes=nsn, num_sampled_edges=nse, metadata=metadata)


def message_to_data(msg: dict, to_device: bool = True, device=None):
  """``SampleMessage`` -> ``loader.Data`` (``HeteroData`` for a message
  flagged ``#META.hetero``). Arrays stay padded. With ``to_device`` each
  array is uploaded once, from its deserialized view, to ``device`` (None
  means the card); without it the batch keeps the numpy arrays, as in
  JAX. Counts, hop counts and metadata stay on the host."""
  if to_device:
    from ..utils import resolve_device
    dev = resolve_device(device)

    def conv(a):
      a = np.asarray(a)
      if dev.type == 'cpu' or not a.flags.writeable:
        # a batch on the CPU owns its memory, never the message's buffer
        return torch.from_numpy(a.copy()).to(dev)
      return torch.from_numpy(a).to(dev)
  else:
    def conv(a):
      return a
  if '#META.hetero' in msg:
    return _hetero_message_to_data(msg, conv)
  node = conv(msg['node'])
  row, col = conv(msg['row']), conv(msg['col'])
  ei = torch.stack([row, col]) if to_device else np.stack([row, col])
  num_nodes = msg.get('num_nodes')
  node_mask = None
  if num_nodes is not None:
    num_nodes = int(np.asarray(num_nodes).reshape(-1)[0])
    rng = (torch.arange(node.shape[0], device=node.device) if to_device
           else np.arange(node.shape[0]))
    node_mask = rng < num_nodes
  metadata = {k[len(META_PREFIX):]: v for k, v in msg.items()
              if k.startswith(META_PREFIX) and k != '#META.batch_size'}
  return Data(
      node=node, num_nodes=num_nodes, node_mask=node_mask, edge_index=ei,
      edge_mask=conv(msg['edge_mask']),
      x=conv(msg['x']) if 'x' in msg else None,
      y=conv(msg['y']) if 'y' in msg else None,
      edge_ids=conv(msg['edge']) if 'edge' in msg else None,
      batch=conv(msg['batch']) if 'batch' in msg else None,
      batch_size=(int(np.asarray(msg['#META.batch_size']).reshape(-1)[0])
                  if '#META.batch_size' in msg else None),
      num_sampled_nodes=msg.get('num_sampled_nodes'),
      num_sampled_edges=msg.get('num_sampled_edges'),
      metadata=metadata)
