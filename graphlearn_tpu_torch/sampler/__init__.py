from .base import NodeSamplerInput, SamplerOutput
from .neighbor_sampler import (NeighborSampler, capacity_plan, tree_layout,
                               tree_layout_from_caps)
