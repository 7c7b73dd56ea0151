from . import conv, convert, train
from .conv import SAGEConv
from .models import GraphSAGE, MergeSAGEConv, TreeSAGEConv
