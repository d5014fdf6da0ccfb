"""Sharded DENSE exact SimRank: S row-sharded, W replicated (counterpart of
``graphtpu/dist/simrank_sharded.py``).

S' = C·W·S·Wᵀ with rank d holding S's row block r_d and the whole dense
row-stochastic W.  An iteration is T = S[r_d] @ Wᵀ (= (S·Wᵀ)[r_d]), one
all-gather of T's row blocks, and S'[r_d] = C·W[r_d] @ (S·Wᵀ), so each rank
does 1/n of the multiply-adds.  The matmuls are plain ``torch.matmul`` at
graphtpu's ``matmul_precision`` (full fp32 by default), as graphtpu leaves
them to XLA outside any Pallas kernel.  Memory: the dense [V, V] W and the
gathered S·Wᵀ on every rank, so this form is for small V; the scale-out
form is :func:`graphtpu_torch.dist.spmm_sharded.sharded_simrank_spmm`.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.device import matmul_precision as precision
from graphtpu_torch.core.graph import Graph, dense_adjacency, row_normalized
from graphtpu_torch.dist.mesh import all_gather
from graphtpu_torch.dist.spmm_sharded import SimBlock
from graphtpu_torch.utils.metrics import StageClock


def sharded_exact_simrank(
    g: Graph,
    mesh,
    cfg: SimRankConfig = SimRankConfig(),
    dtype=torch.float32,
    matmul_precision: str = "highest",
    stage_times: Optional[dict] = None,
) -> SimBlock:
    """Dense SimRank with S row-sharded over the mesh's first axis
    ("data"); returns this rank's row block of the [V, V] result (diag
    zeroed).  ``matmul_precision``: graphtpu's names
    (:data:`graphtpu_torch.core.device.MATMUL_TF32`; "default" allows
    TF32).  ``stage_times``: ms of building the dense W ("plan"), the
    matmuls ("matmul") and the all-gathers ("wire")."""
    axis = mesh.axis_names[0]
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group = mesh.groups[axis]
    stages = StageClock(stage_times, mesh.device, sync=True)
    v = g.n_nodes
    per = -(-v // n)
    lo, hi = min(me * per, v), min((me + 1) * per, v)
    w = stages.stage("plan",
                     lambda: row_normalized(dense_adjacency(g, device=mesh.device)).to(dtype))
    w_me = w[lo:hi]
    eye = torch.eye(v, dtype=dtype, device=mesh.device)[lo:hi]
    s = eye.clone()
    with precision(matmul_precision):
        for _ in range(cfg.iterations):
            t = stages.stage("matmul", torch.matmul, s, w.T)              # (S·Wᵀ)[r_me]
            t = torch.cat([t, t.new_zeros((per - t.shape[0], v))])
            m = stages.stage("wire", all_gather, t, group).reshape(n * per, v)[:v]
            s = cfg.c * stages.stage("matmul", torch.matmul, w_me, m)
            s = s * (1 - eye) + eye
    return SimBlock(values=s * (1 - eye), row_lo=lo, col_lo=0, n_nodes=v)
