"""Tensor ops of the port: sampling (with the partition-local hops of the
distributed engine), induction, gathers, collation, the exchange's
routing (``route``) and stitching, the hop keys of a chunk of steps.

The CUDA kernels (``gather_rows_hbm``, ``gather_rows_hbm2``, the hot/cold
``gather_rows_unified``, their row-sharded entries ``gather_rows_sharded``
and ``gather_rows_unified_sharded`` (a device group's table; ``peer``
enables the cards' peer access), the fused
hop ``sample_hop_fused``, the fused level ``sample_level_fused``, the
chunk's ``step_keys`` and the distributed chunk's
``dist_step_keys``, the sampling backends' draw ``draw.uniform``, the
negative sampler's draw and test ``random_negative_sample`` (and its
shard-local entry ``random_negative_sample_local``) and the
probes' ``row_gather_probe``, one counter per route, and
``smem_take``) keep launch counters; ``launch_counts``
reads them (``sample_hop`` and ``sample_level`` name the two sampling
kernels), ``reset_launch_counts`` sets them to 0 and
``add_launch_counts`` adds a recorded set (a CUDA graph's replay).
"""
from . import (draw, gather, kernels, keys, mapped, negative, peer, probes,
               sample_fused)
from .collate import (collate_batch, gather_rows, stack2, stack2_batched,
                      valid_mask)
from .gather import (ShardedRows, apply_gather_plan, decode_gather_plan,
                     gather_rows_hbm, gather_rows_hbm2,
                     gather_rows_hbm2_plain, gather_rows_plain,
                     gather_rows_sharded, gather_rows_sharded_plain,
                     gather_rows_unified, gather_rows_unified_plain,
                     gather_rows_unified_sharded,
                     gather_rows_unified_sharded_plain, plan_gather_runs,
                     plan_runs_in_tiles)
from .induce import InducerState, induce_next, init_empty, init_node
from .induce_map import MapInducerState, induce_next_map, init_node_map
from .induce_merge import (MergeInducerState, induce_next_merge,
                           init_empty_merge, init_node_merge)
from .induce_tree import (TreeInducerState, induce_next_tree,
                          init_empty_tree, init_node_tree)
from .keys import dist_step_keys, step_keys
from .neighbor import (BLOCK, build_padded_adjacency,
                       build_padded_adjacency_device, build_row_cumsum,
                       choose_padded_window, edge_in_csr,
                       padded_table_stats,
                       uniform_sample, uniform_sample_block,
                       uniform_sample_local, uniform_sample_padded,
                       weighted_sample, weighted_sample_local)
from .negative import (random_negative_sample,
                       random_negative_sample_local,
                       random_negative_sample_local_plain,
                       random_negative_sample_plain, sort_csr_rows,
                       sort_csr_segments)
from .probes import (row_gather_probe, row_gather_probe_plain,
                     row_gather_route, smem_take, smem_take_plain)
from .route import (exchange_capacity, gather_from_buckets, round8,
                    route_slots, scatter_to_buckets)
from .sample_fused import (LevelScratch, sample_hop_fused,
                           sample_level_fused, sample_level_fused_plain,
                           sample_level_plain)
from .stitch import stitch_rows
from .subgraph import (node_subgraph, node_subgraph_bucketed,
                       node_subgraph_local)
from .unique import FILL, masked_unique, searchsorted_membership


# launch_counts() name -> (module, counter attribute)
_COUNTERS = {
    'gather_rows': (gather, 'launches'),
    'gather_runs': (gather, 'runs_launches'),
    'gather_unified': (gather, 'unified_launches'),
    'gather_rows_sharded': (gather, 'sharded_launches'),
    'gather_unified_sharded': (gather, 'unified_sharded_launches'),
    'sample_hop': (sample_fused, 'launches'),
    'sample_level': (sample_fused, 'level_launches'),
    'step_keys': (keys, 'launches'),
    'dist_step_keys': (keys, 'dist_launches'),
    'uniform_draw': (draw, 'launches'),
    'negative_sample': (negative, 'launches'),
    'negative_sample_local': (negative, 'local_launches'),
    'row_gather_probe_bulk': (probes, 'row_gather_bulk_launches'),
    'row_gather_probe_vector': (probes, 'row_gather_vector_launches'),
    'smem_take': (probes, 'smem_take_launches'),
}


def launch_counts() -> dict:
  with kernels.COUNT_LOCK:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts():
  with kernels.COUNT_LOCK:
    for mod, attr in _COUNTERS.values():
      setattr(mod, attr, 0)


def add_launch_counts(counts: dict):
  """Add ``counts`` (``launch_counts()`` names) to the counters: the
  launches a replayed CUDA graph made, as recorded when it was captured."""
  with kernels.COUNT_LOCK:
    for name, n in counts.items():
      mod, attr = _COUNTERS[name]
      setattr(mod, attr, getattr(mod, attr) + n)
