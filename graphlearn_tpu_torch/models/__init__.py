from . import conv, convert, hgt, train
from .conv import (GATConv, GCNConv, SAGEConv, segment_max_agg,
                   segment_mean_agg, segment_sum_agg)
from .hgt import HGT, HGTConv
from .models import (GAT, GCN, RGNN, GraphSAGE, HeteroConv, MergeGATConv,
                     MergeSAGEConv, TreeGATConv, TreeHeteroConv,
                     TreeSAGEConv, run_impl_decision)
from .train import (TrainState, batch_to_dict, create_train_state,
                    make_train_step, merge_hop_offsets, tree_hop_offsets)
