"""Multi-rank programs on ``torch.distributed`` (counterpart of
``graphtpu/dist``): meshes and the local launcher, the partitioned CSR,
sharded exact SimRank (dense, the 1-D ring and 2-D SUMMA, kernel B3 in
every rank), the frontier exchange with partitioned-graph walks, UniWalk,
TopSim and node2vec, SGNS with the batch over ``data`` and the tables
row-sharded over ``model``, and source windows with a durable cursor."""

from graphtpu_torch.dist.frontier import (
    distributed_uniform_walks,
    exchange_by_owner,
    narrowest_int_dtype,
    reset_wire_stats,
    wire_stats,
)
from graphtpu_torch.dist.mesh import device_count, make_2d_mesh, make_mesh, spawn
from graphtpu_torch.dist.sgns_dp import gather_params, make_sgns_train_step
from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
from graphtpu_torch.dist.spmm_summa import summa_simrank_spmm

__all__ = [
    "make_mesh",
    "device_count",
    "make_sgns_train_step",
    "gather_params",
    "sharded_exact_simrank",
    "exchange_by_owner",
    "distributed_uniform_walks",
    "narrowest_int_dtype",
    "reset_wire_stats",
    "wire_stats",
    "make_2d_mesh",
    "summa_simrank_spmm",
    "spawn",
]
