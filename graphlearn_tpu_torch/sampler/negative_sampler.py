"""Random negative edge sampler.

Counterpart of ``graphlearn_tpu/sampler/negative_sampler.py``: an object
over ``ops.random_negative_sample`` with a counter-addressed key (call N
draws from ``fold_in(base, N)``, never a carried split) and the
``edge_dir='in'`` flip (a CSC graph stores (dst, src) pairs).
"""
from typing import Optional

from .. import ops
from .. import random as trandom
from ..data import Graph


class RandomNegativeSampler:
  """``(src, dst)`` pairs absent from ``graph``, on the graph's device."""

  def __init__(self, graph: Graph, mode: str = 'binary',
               edge_dir: str = 'out', seed: Optional[int] = None):
    self.graph = graph
    self.mode = mode
    self.edge_dir = edge_dir
    self._key = trandom.PRNGKey(0 if seed is None else seed)
    self._call_count = 0
    self._sorted_indices = ops.sort_csr_rows(graph.indptr, graph.indices)

  def sample(self, num_samples: int, trials: int = 5,
             padding: bool = False):
    """``(rows, cols, mask)``; with ``padding`` the output is always full
    (non-strict mode)."""
    g = self.graph
    self._call_count += 1
    key = trandom.fold_in(self._key, self._call_count)
    rows, cols, mask = ops.random_negative_sample(
        g.indptr, self._sorted_indices, g.num_nodes, g.num_nodes,
        num_samples, key, trials=trials, padding=padding)
    if self.edge_dir == 'in':
      rows, cols = cols, rows
    return rows, cols, mask
