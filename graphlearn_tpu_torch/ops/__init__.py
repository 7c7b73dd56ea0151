"""Tensor ops of the port: sampling, induction, gathers, collation.

The three CUDA kernels (``gather_rows_hbm``, ``sample_hop``,
``sample_level``) keep launch counters; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0.
"""
from . import gather, kernels, sample_fused
from .collate import collate_batch
from .gather import gather_rows_hbm, gather_rows_plain
from .induce_merge import (MergeInducerState, induce_next_merge,
                           init_node_merge)
from .induce_tree import TreeInducerState, induce_next_tree, init_node_tree
from .neighbor import uniform_sample
from .sample_fused import (sample_hop, sample_hop_fused, sample_hop_plain,
                           sample_level, sample_level_fused,
                           sample_level_plain)
from .unique import FILL, masked_unique


def launch_counts() -> dict:
  return {'gather_rows': gather.launches, 'sample_hop': sample_fused.launches,
          'sample_level': sample_fused.level_launches}


def reset_launch_counts():
  gather.launches = 0
  sample_fused.launches = 0
  sample_fused.level_launches = 0
