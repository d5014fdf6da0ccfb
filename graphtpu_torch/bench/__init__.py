from graphtpu_torch.bench.generators import (
    uniform_random_graph,
    bipartite_random_graph,
    directed_random_graph,
    rmat_graph,
    massive_bipartite_graph,
)

__all__ = [
    "uniform_random_graph",
    "bipartite_random_graph",
    "directed_random_graph",
    "rmat_graph",
    "massive_bipartite_graph",
]
