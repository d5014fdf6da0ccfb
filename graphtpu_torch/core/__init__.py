from graphtpu_torch.core.graph import (
    Graph,
    DiGraph,
    build_graph,
    read_edgelist_graph,
    padded_neighbors,
    dense_adjacency,
    column_normalized,
)
from graphtpu_torch.core import config
from graphtpu_torch.core.prng import key_for

__all__ = [
    "Graph",
    "DiGraph",
    "build_graph",
    "read_edgelist_graph",
    "padded_neighbors",
    "dense_adjacency",
    "column_normalized",
    "config",
    "key_for",
]
