from . import calibrate
from .base import (EdgeSamplerInput, NegativeSampling, NeighborOutput,
                   NodeSamplerInput, SamplerOutput)
from .negative_sampler import RandomNegativeSampler
from .neighbor_sampler import (NeighborSampler, capacity_plan,
                               merge_layout_from_caps, tree_layout,
                               tree_layout_from_caps)
