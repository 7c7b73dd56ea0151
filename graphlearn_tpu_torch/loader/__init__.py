from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .pipeline import FusedEpochTrainer, OverlappedTrainer
from .run_epoch import RunTrainer
from .scan_epoch import ScanTrainer
from .transform import Data, to_data
