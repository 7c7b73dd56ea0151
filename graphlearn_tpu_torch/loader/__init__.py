from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .transform import Data, to_data
