"""Hotness reorder of feature rows by in-degree.

Counterpart of ``graphlearn_tpu/data/reorder.py`` (the port's own copy of
its numpy code): rows are permuted so the hottest (highest in-degree)
vertices come first, which lets the feature store keep a prefix of rows
on the device and the tail on the host. Returns the permuted features
plus the old-id -> new-row map (``id2index``) that lookups apply.
"""
from typing import Iterable, Tuple

import numpy as np


def in_degree_hotness(topology, num_nodes: int) -> np.ndarray:
  """``[num_nodes]`` in-degree hotness scores (higher = hotter): a CSC
  topology's degrees, or a CSR topology's column counts."""
  in_deg = np.zeros((num_nodes,), dtype=np.int64)
  if topology.layout == 'CSC':
    d = topology.degrees
    in_deg[:d.shape[0]] = d
  else:
    np.add.at(in_deg, topology.indices,
              np.ones_like(topology.indices, dtype=np.int64))
  return in_deg


def frequency_hotness(id_batches: Iterable, num_nodes: int) -> np.ndarray:
  """``[num_nodes]`` presampling frequency hotness: how often each id
  appears across ``id_batches`` (arrays of visited node ids; negative
  FILL pads and ids past ``num_nodes`` are ignored)."""
  counts = np.zeros((num_nodes,), dtype=np.int64)
  for ids in id_batches:
    ids = np.asarray(ids).reshape(-1)
    ids = ids[(ids >= 0) & (ids < num_nodes)]
    np.add.at(counts, ids, 1)
  return counts


def sort_by_in_degree(
    feature: np.ndarray,
    split_ratio: float,
    topology,
) -> Tuple[np.ndarray, np.ndarray]:
  """Reorder ``feature`` rows hot-first by in-degree (a full, stable,
  descending sort; ``split_ratio`` only matters to the caller's split).

  Returns ``(reordered [N, F], id2index [N])`` with
  ``reordered[id2index[v]] == feature[v]``.
  """
  n = feature.shape[0]
  in_deg = in_degree_hotness(topology, n)
  del split_ratio
  order = np.argsort(-in_deg, kind='stable')  # hot first
  id2index = np.empty((n,), dtype=np.int64)
  id2index[order] = np.arange(n, dtype=np.int64)
  return feature[order], id2index
