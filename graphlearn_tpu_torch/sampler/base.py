"""Sampler input/output containers.

Counterpart of ``graphlearn_tpu/sampler/base.py`` (``NodeSamplerInput``,
``SamplerOutput``). Outputs are fixed-shape and mask-padded: ``node`` /
``row`` / ``col`` are padded to static capacities, validity rides in
``edge_mask`` and the 0-d ``num_nodes`` tensor.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class NodeSamplerInput:
  """Seed nodes for node-based sampling."""
  node: np.ndarray
  input_type: Optional[str] = None

  def __len__(self):
    return int(np.asarray(self.node).shape[0])


@dataclass
class SamplerOutput:
  """Multi-hop subgraph sample.

  node: ``[cap_n]`` global ids, position == local index, FILL-padded.
  num_nodes: 0-d count of valid slots.
  row / col: ``[cap_e]`` local endpoints (row = message source), -1 where
    invalid. edge_mask: ``[cap_e]`` validity.
  batch: ``[B]`` padded seed ids; batch_size: number of real seeds.
  num_sampled_nodes / num_sampled_edges: per-hop 0-d counts.
  """
  node: Any
  num_nodes: Any = None
  row: Any = None
  col: Any = None
  edge: Optional[Any] = None
  edge_mask: Any = None
  batch: Optional[Any] = None
  batch_size: Optional[int] = None
  num_sampled_nodes: Optional[List[Any]] = None
  num_sampled_edges: Optional[List[Any]] = None
  input_type: Optional[str] = None
  metadata: Dict[str, Any] = field(default_factory=dict)
