from .link_loader import LinkLoader
from .link_neighbor_loader import LinkNeighborLoader
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .pipeline import (DistFusedEpochTrainer, FusedEpochTrainer,
                       OverlappedTrainer)
from .run_epoch import RunTrainer
from .scan_epoch import DistScanTrainer, ScanTrainer
from .subgraph_loader import SubGraphLoader
from .transform import Data, HeteroData, to_data, to_hetero_data
