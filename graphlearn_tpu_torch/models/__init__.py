from . import convert, train
from .models import GraphSAGE, TreeSAGEConv
