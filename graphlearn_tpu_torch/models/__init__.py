from . import conv, convert, train
from .conv import GATConv, SAGEConv
from .models import (RGNN, GraphSAGE, HeteroConv, MergeSAGEConv,
                     TreeHeteroConv, TreeSAGEConv)
