from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .pipeline import FusedEpochTrainer
from .scan_epoch import ScanTrainer
from .transform import Data, to_data
