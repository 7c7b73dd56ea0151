"""Tabular dataset loading.

Counterpart of ``graphlearn_tpu/data/table_dataset.py``: graph topology
and node features read from tables by a pool of reader threads. ODPS
(MaxCompute) tables need the ``common_io`` package, which is not here,
so ``odps://`` paths raise; local ``.npy`` / ``.npz`` / ``.csv`` tables
take the same multi-reader path.
"""
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from .dataset import Dataset


def _load_table(path: str):
  if path.endswith('.npy'):
    return np.load(path)
  if path.endswith('.npz'):
    with np.load(path) as z:
      return {k: z[k] for k in z.files}
  if path.endswith('.csv'):
    return np.loadtxt(path, delimiter=',', dtype=np.float64)
  raise ValueError(f'unsupported table format: {path!r}')


class TableDataset(Dataset):
  """A ``Dataset`` read from tables.

  ``edge_tables`` / ``node_tables``: file paths (or ``odps://`` URLs when
  ``common_io`` exists). Edge tables are ``[2, E]`` or ``[E, 2]`` id
  pairs; node tables are ``.npz`` with ``ids`` and ``feats`` (and
  optional ``labels``). The tables are read on ``num_threads`` reader
  threads. As in the JAX package the graph defaults to the device
  (``graph_mode='HBM'``) and the features to the host (``split_ratio=
  0.0``): on a card every feature lookup is the hot/cold gather's.
  """

  def __init__(self, edge_tables: Optional[Sequence[str]] = None,
               node_tables: Optional[Sequence[str]] = None,
               graph_mode: str = 'HBM', split_ratio: float = 0.0,
               device=None, num_threads: int = 4, edge_dir: str = 'out',
               **kwargs):
    super().__init__(edge_dir=edge_dir, device=device)
    if edge_tables and any(str(t).startswith('odps://')
                           for t in edge_tables):
      try:
        import common_io  # noqa: F401
      except ImportError as e:
        raise ImportError(
            'ODPS tables require the common_io package (Alibaba '
            'internal); use local .npy/.npz/.csv tables instead') from e
    self._load(edge_tables or [], node_tables or [], graph_mode,
               split_ratio, num_threads)

  def _load(self, edge_tables, node_tables, graph_mode, split_ratio,
            num_threads):
    edge_parts: List[Optional[np.ndarray]] = [None] * len(edge_tables)
    node_parts: List[Optional[dict]] = [None] * len(node_tables)

    def read_edge(i, path):
      arr = np.asarray(_load_table(path))
      if arr.ndim == 2 and arr.shape[0] != 2:
        arr = arr.T
      edge_parts[i] = arr.astype(np.int64)

    def read_node(i, path):
      z = _load_table(path)
      if not (isinstance(z, dict) and 'ids' in z and 'feats' in z):
        raise ValueError(f'node table {path!r} needs ids + feats arrays')
      node_parts[i] = z

    # the first reader failure is raised here; still-queued reads are
    # dropped instead of finished
    pool = ThreadPoolExecutor(max_workers=max(num_threads, 1))
    try:
      futures = [pool.submit(read_edge, i, p)
                 for i, p in enumerate(edge_tables)]
      futures += [pool.submit(read_node, i, p)
                  for i, p in enumerate(node_tables)]
      for fut in futures:
        fut.result()
    finally:
      pool.shutdown(wait=True, cancel_futures=True)

    if edge_parts:
      edge_index = np.concatenate(edge_parts, axis=1)
      self.init_graph(edge_index, graph_mode=graph_mode)
    if node_parts:
      ids = np.concatenate([z['ids'] for z in node_parts])
      feats = np.concatenate([z['feats'] for z in node_parts])
      order = np.argsort(ids)
      self.init_node_features(feats[order], split_ratio=split_ratio)
      if all('labels' in z for z in node_parts):
        labels = np.concatenate([z['labels'] for z in node_parts])[order]
        self.init_node_labels(labels)
