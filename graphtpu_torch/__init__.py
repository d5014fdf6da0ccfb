"""graphtpu_torch — the PyTorch/CUDA port of graphtpu, for NVIDIA Hopper.

Each module sits opposite its ``graphtpu`` counterpart:
  core/     CSR graph containers, typed config, relabeling, plan and weight
            conversion, devices, named random streams
  io/       edge-list, ``.sim.txt``, ``.emb`` and ``.mat`` readers and writers
  kernels/  sparse product plans (item streams, reduction trees), the hand
            CUDA kernels (csrc/), top-k and segment sums, neighbour
            sampling, edge-membership sets
  walks/    first- and second-order (node2vec) random walks
  models/   SGNS (skip-gram with negative sampling), checkpoints
  eval/     TopKRanker micro/macro-F1
  simrank/  exact SimRank, dense and sparse (stream or tree)
  pipelines node2vec: walks -> SGNS -> ``.emb``
  bench/    synthetic graph generators, the SpMV item-rate probe, the
            embedding path's profile
This package imports neither ``jax`` nor ``graphtpu``.
"""

__version__ = "0.1.0"

from graphtpu_torch.core.graph import (
    DiGraph,
    Graph,
    build_graph,
    read_edgelist_graph,
)

__all__ = ["Graph", "DiGraph", "build_graph", "read_edgelist_graph", "__version__"]
