from . import conv, convert, hgt, train
from .conv import GATConv, GCNConv, SAGEConv
from .hgt import HGT, HGTConv
from .models import (GAT, GCN, RGNN, GraphSAGE, HeteroConv, MergeGATConv,
                     MergeSAGEConv, TreeGATConv, TreeHeteroConv,
                     TreeSAGEConv, run_impl_decision)
