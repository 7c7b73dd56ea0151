from .dataset import Dataset
from .feature import Feature
from .graph import Graph, Topology
from .unified_tensor import UnifiedTensor
