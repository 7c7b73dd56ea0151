"""Shared plumbing of the fused epoch trainers.

Counterpart of ``graphlearn_tpu/loader/pipeline.py:FusedEpochTrainer``:
the scope checks, the device feature and label tables, and the
sample+collate body an epoch trainer (``loader.ScanTrainer``) runs for
every step. The JAX package traces that body into its programs. Here it
runs on the loader's device with no host step in it: it takes the step's
hop keys as a device tensor, reads nothing back and allocates only by
static shapes, so ``ScanTrainer`` can capture it into a CUDA graph (or
run it eagerly). ``OverlappedTrainer`` (batch n's train step fused with
batch n+1's sampling) is not ported.
"""
from typing import Optional

from .. import ops
from ..models import train as train_lib
from .node_loader import NodeLoader

_RECOMPUTE_MSG = (
    "overflow_policy='recompute' needs a device->host sync per batch, "
    'which defeats the fused epoch. Use the plain loader loop for '
    "recompute, or overflow_policy='raise'/'warn' here (the flag "
    'accumulates on the device and is checked once at epoch end).')


class FusedEpochTrainer:
  """Scope validation, device tables and the sample+collate body.

  Requirements: a homogeneous ``NodeLoader`` over a device-resident
  feature table with node labels, no edge features (supervised node
  classification, the JAX trainers' scope).
  """

  _NAME = 'FusedEpochTrainer'

  def __init__(self, loader: NodeLoader, model, num_classes: int,
               seed_labels_only: Optional[bool] = None):
    sampler = loader.sampler
    if getattr(sampler, 'is_hetero', False):
      raise ValueError(f'{self._NAME} is homogeneous-only')
    if getattr(sampler, 'with_edge', False):
      raise ValueError('with_edge batches are not supported in the fused '
                       'epoch trainers')
    if getattr(sampler, 'clamped_exact', False) and \
        loader.overflow_policy == 'recompute':
      raise ValueError(_RECOMPUTE_MSG)
    self.loader = loader
    self.model = model
    self.num_classes = num_classes
    self._sampler = sampler
    self._batch_size = loader.batch_size
    if seed_labels_only is None:
      seed_labels_only = loader.seed_labels_only
    self._label_cap = self._batch_size if seed_labels_only else None
    if loader.data.node_features is None:
      raise ValueError(f'{self._NAME} needs a device-resident feature '
                       'table')
    self._feats, self._id2i = loader.data.node_features.device_table()
    self._labels = loader.data.node_labels
    if self._labels is None:
      raise ValueError(f'{self._NAME} needs node labels')
    self._train_step, _ = train_lib.make_train_step(model, num_classes)
    self._sample_collate = self._make_sample_collate_body()

  def _make_sample_collate_body(self):
    """``(seeds, seed_mask, hop_keys) -> (batch, overflow)``: one batch
    sampled under the ``[n_hops, 2]`` device hop keys and collated on the
    device. The calibrated-caps overflow flag rides outside the batch
    dict (the train step does not see it)."""
    sampler, label_cap = self._sampler, self._label_cap
    feats, id2i, labels = self._feats, self._id2i, self._labels

    def _sample_collate(seeds, smask, hop_keys):
      res = sampler._sample(seeds, smask, hop_keys=hop_keys)
      col = ops.collate_batch(res['node'], res['num_nodes'], res['row'],
                              res['col'], feats, id2i, labels, None, None,
                              label_cap=label_cap)
      batch = dict(x=col['x'], edge_index=col['edge_index'],
                   edge_mask=res['edge_mask'], y=col['y'],
                   num_seed_nodes=res['num_sampled_nodes'][0])
      return batch, res['overflow']

    return _sample_collate
