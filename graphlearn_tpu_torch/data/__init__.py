from .dataset import Dataset
from .feature import DeviceGroup, Feature
from .graph import Graph, Topology
from .reorder import (frequency_hotness, in_degree_hotness,
                      sort_by_in_degree)
from .table_dataset import TableDataset
from .unified_tensor import UnifiedTensor
from . import vineyard_utils
