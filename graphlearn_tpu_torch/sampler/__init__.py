from . import calibrate
from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NegativeSampling, NeighborOutput, NodeSamplerInput,
                   RemoteNodePathSamplerInput, RemoteSamplerInput,
                   SamplerOutput, SamplingConfig, SamplingType)
from .capacity import (DEFAULT_ETYPE, DEFAULT_NTYPE, CapacityPlan,
                       CapacityPlanError, ack_edge_ids)
from .calibrate import (check_no_overflow, estimate_frontier_caps,
                        estimate_hetero_frontier_caps, link_seed_width,
                        normalize_hetero_frontier_caps)
from .negative_sampler import RandomNegativeSampler
from .neighbor_sampler import (NeighborSampler, capacity_plan,
                               hetero_capacity_plan, hetero_tree_blocks,
                               hetero_tree_layout, merge_layout_from_caps,
                               tree_layout, tree_layout_from_caps)
