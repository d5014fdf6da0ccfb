"""graphtpu_torch — the PyTorch/CUDA port of graphtpu, for NVIDIA Hopper.

Each module sits opposite its ``graphtpu`` counterpart:
  core/     CSR graph containers, typed config, relabeling, plan conversion
  io/       edge-list and ``.sim.txt`` readers and writers
  kernels/  sparse product plans (item streams, reduction trees), the hand
            CUDA kernels (csrc/), top-k
  simrank/  exact SimRank, dense and sparse (stream or tree)
  bench/    synthetic graph generators, the SpMV item-rate probe
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
