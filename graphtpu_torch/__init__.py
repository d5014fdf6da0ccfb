"""graphtpu_torch — the PyTorch/CUDA port of graphtpu, for NVIDIA Hopper.

Each module sits opposite its ``graphtpu`` counterpart:
  core/     CSR graph containers (with a ``.csr.npz`` cache), typed config,
            relabeling, plan and weight conversion, devices, named random
            streams, the dataset registry, BFS distances, weight statistics
  io/       edge-list, ``.sim.txt``, ``.emb`` and ``.mat`` readers and
            writers, a sqlite result store
  native/   the C++ edge-list parser and graph generator (g++, ctypes)
  kernels/  sparse product plans (item streams, reduction trees), the hand
            CUDA kernels (csrc/), top-k, segment sums and the sort-based
            and bounded top-k accumulators, neighbour sampling,
            edge-membership sets
  walks/    first- and second-order (node2vec) random walks
  models/   SGNS (skip-gram with negative sampling), checkpoints, the
            DeepSim and SDNE autoencoders, Laplacian Eigenmaps
  eval/     TopKRanker micro/macro-F1, top-k precision and NDCG, path and
            label feature emitters
  simrank/  exact SimRank, dense and sparse (stream or tree); the
            Monte-Carlo engines: UniWalk, TopSim, double walks,
            meeting-probability estimators and TopSim_Dev
  dist/     multi-rank programs on torch.distributed: meshes and a local
            launcher, the partitioned CSR, sharded exact SimRank (dense,
            the 1-D ring and 2-D SUMMA on kernel B3), the frontier
            exchange with partitioned-graph walks, UniWalk, TopSim and
            node2vec, data-parallel SGNS, source windows with a durable
            cursor
  utils/    logs, step metrics, profiler traces
  pipelines node2vec: walks -> SGNS -> ``.emb``
  pipelines_deepsim  DeepSim: ``.sim.txt`` + walks -> autoencoder -> W1
  viz       PNG plots of the LE flows (matplotlib, imported when used)
  dryrun    every dist entry point once on N local ranks
  bench/    synthetic graph generators, kernel bounds and timing, the
            SpMV item-rate probe, the packed-lane and transpose probes,
            walk diagnostics, gold-standard sweeps, the 10M flagship
This package imports neither ``jax`` nor ``graphtpu``.
"""

__version__ = "0.1.0"

from graphtpu_torch.core.graph import (
    DiGraph,
    Graph,
    build_graph,
    load_graph_cached,
    read_edgelist_graph,
)

__all__ = ["Graph", "DiGraph", "build_graph", "load_graph_cached", "read_edgelist_graph",
           "__version__"]
