"""Tensor ops of the port: sampling, induction, gathers, collation.

The two CUDA kernels (``gather_rows_hbm``, ``sample_hop``) keep launch
counters; ``launch_counts`` reads them and ``reset_launch_counts`` sets
them to 0.
"""
from . import gather, kernels, sample_fused
from .collate import collate_batch
from .gather import gather_rows_hbm, gather_rows_plain
from .induce_tree import TreeInducerState, induce_next_tree, init_node_tree
from .neighbor import uniform_sample
from .sample_fused import sample_hop, sample_hop_fused, sample_hop_plain
from .unique import FILL


def launch_counts() -> dict:
  return {'gather_rows': gather.launches, 'sample_hop': sample_fused.launches}


def reset_launch_counts():
  gather.launches = 0
  sample_fused.launches = 0
