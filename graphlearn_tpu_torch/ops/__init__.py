"""Tensor ops of the port: sampling, induction, gathers, collation.

The six CUDA kernels (``gather_rows_hbm``, ``gather_rows_hbm2``, the
fused hop ``sample_hop_fused``, the fused level ``sample_level_fused``
and the probes' ``row_gather_probe`` and ``smem_take``) keep launch
counters; ``launch_counts`` reads them (``sample_hop`` and
``sample_level`` name the two sampling kernels) and
``reset_launch_counts`` sets them to 0.
"""
from . import gather, kernels, probes, sample_fused
from .collate import collate_batch
from .gather import (apply_gather_plan, decode_gather_plan, gather_rows_hbm,
                     gather_rows_hbm2, gather_rows_hbm2_plain,
                     gather_rows_plain, plan_gather_runs, plan_runs_in_tiles)
from .induce_merge import (MergeInducerState, induce_next_merge,
                           init_node_merge)
from .induce_tree import TreeInducerState, induce_next_tree, init_node_tree
from .neighbor import uniform_sample
from .probes import (row_gather_probe, row_gather_probe_plain, smem_take,
                     smem_take_plain)
from .sample_fused import (LevelScratch, sample_hop_fused,
                           sample_level_fused, sample_level_fused_plain,
                           sample_level_plain)
from .unique import FILL, masked_unique


def launch_counts() -> dict:
  return {'gather_rows': gather.launches,
          'gather_runs': gather.runs_launches,
          'sample_hop': sample_fused.launches,
          'sample_level': sample_fused.level_launches,
          'row_gather_probe': probes.row_gather_launches,
          'smem_take': probes.smem_take_launches}


def reset_launch_counts():
  gather.launches = 0
  gather.runs_launches = 0
  sample_fused.launches = 0
  sample_fused.level_launches = 0
  probes.row_gather_launches = 0
  probes.smem_take_launches = 0
