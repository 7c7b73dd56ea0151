from . import calibrate
from .base import NodeSamplerInput, SamplerOutput
from .neighbor_sampler import (NeighborSampler, capacity_plan,
                               merge_layout_from_caps, tree_layout,
                               tree_layout_from_caps)
