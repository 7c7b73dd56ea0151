from . import convert, train
from .models import GraphSAGE, MergeSAGEConv, TreeSAGEConv
