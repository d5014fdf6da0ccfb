"""Exact iterative SimRank (counterpart of ``graphtpu/simrank/exact.py``).

The reference computes sim'(i,j) = C/(d_i d_j) Σ_{u∈N(i), v∈N(j)} sim(u,v)
with the diagonal pinned to 1 during iteration and zeroed afterwards
(``simrank/SimRank.java:36-77``).  With P the row-stochastic adjacency that
is S' = C·P·S·Pᵀ, run two ways:

* :func:`exact_simrank`: two dense matmuls per iteration, in full fp32
  by default (TF32 off), the gold;
* :func:`exact_simrank_spmm`: two sparse products per iteration and one
  transpose, through the item stream (:func:`graphtpu_torch.kernels.spmm.spmv`)
  or the reduction tree (:func:`graphtpu_torch.kernels.spmm.tree_spmm`).

A :class:`DiGraph` gets directed SimRank over in-neighbours (the in-CSR).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import SimRankConfig, WeightedSimRankConfig
from graphtpu_torch.core.device import matmul_precision as precision, resolve_device
from graphtpu_torch.core.graph import DiGraph, Graph, dense_adjacency, row_normalized
from graphtpu_torch.kernels.spmm import (
    build_reduction_tree,
    build_spmv_segments,
    build_spmv_stream,
    layout_of,
    spmv,
    tree_spmm,
)
from graphtpu_torch.kernels.topk import topk_rows


def _simrank_iterate(w: torch.Tensor, c: float, iterations: int) -> torch.Tensor:
    """Iterate S' = C·W·S·Wᵀ from S = I with W row-stochastic; diag zeroed."""
    v = w.shape[0]
    eye = torch.eye(v, dtype=w.dtype, device=w.device)
    s = eye
    for _ in range(iterations):
        s = c * (w @ (s @ w.T))
        # pin the diagonal to 1 between iterations (SimRank.java:27-30)
        s = s * (1 - eye) + eye
    return s * (1 - eye)


def exact_simrank(
    g: Graph,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    dtype=torch.float32,
    matmul_precision: str = "highest",
    device=None,
) -> torch.Tensor:
    """Dense [V, V] SimRank scores (diag zeroed).  ``matmul_precision``
    takes graphtpu's names (:data:`graphtpu_torch.core.device.MATMUL_TF32`):
    "highest" (the default) and "high" run full fp32 with TF32 off,
    "default" lets cuBLAS use TF32.  Runs on ``device`` (default ``cuda``,
    see :func:`resolve_device`)."""
    if isinstance(g, DiGraph):
        g = g.in_  # in-neighbour rows: P[i, u] = w(u->i) / sum_in(i)
    a = dense_adjacency(g, dtype=torch.float32, device=resolve_device(device))
    if not weighted and g.weight is not None:
        a = (a > 0).to(torch.float32)
    w = row_normalized(a).to(dtype)
    with precision(matmul_precision):
        return _simrank_iterate(w, cfg.c, cfg.iterations)


class _StageClock:
    """Adds each stage's time to ``times[name]`` in ms: CUDA events on a
    CUDA device (read once, after the loop), the host clock otherwise."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times = times
        self.cuda = device.type == "cuda"
        self.marks = []

    def stage(self, name, fn, *args, **kw):
        if self.times is None:
            return fn(*args, **kw)
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.marks.append((name, a, b))
            return out
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.times[name] = self.times.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    def close(self):
        if self.times is None or not self.marks:
            return
        torch.cuda.synchronize()
        for name, a, b in self.marks:
            self.times[name] = self.times.get(name, 0.0) + a.elapsed_time(b)


def exact_simrank_spmm(
    g: Graph,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    dtype=torch.float32,
    spmv_mode: str = "kahan",
    spmv_seg: int = 1,
    device=None,
    stage_times: Optional[dict] = None,
    impl: str = "stream",
    width: int = 8,
    col_block: int = 4096,
) -> torch.Tensor:
    """Exact SimRank with sparse products: [V, V] scores, diag zeroed.

    Same fixed point as :func:`exact_simrank`.  S is symmetric, so
    ``P·(P·S)ᵀ = P·S·Pᵀ`` and each iteration spends one transpose.

    ``impl="stream"`` (graphtpu's ``impl="pallas"`` branch): item-stream
    products (kernels B1/B2).  Iteration 0 multiplies the identity; every
    later iteration's first product reads the previous raw output with the
    ``where(col == row, 1, c·x)`` scale-and-pin fused into the kernel's
    gather (``table_scale=c``).  After the loop one scale-pin and the
    diagonal zeroing give the result.  ``spmv_mode``: "kahan" (compensated
    f32 row sums, the gold) or "fast" (plain f32 row sums);
    ``dtype=torch.bfloat16`` with "fast" keeps bf16 iterates ("fast16").
    ``spmv_seg=k`` uses the coalesced k-row stream.

    ``impl="tree"`` (graphtpu's ``impl="xla"`` branch): reduction-tree
    products of ``width``-slot mini-rows (kernel B3), column-blocked at
    ``col_block``.  Each iteration computes ``c·P·(P·S)ᵀ`` in f32, pins the
    diagonal to 1 and casts to ``dtype``.  ``spmv_mode`` and ``spmv_seg``
    do not apply, and a value other than their defaults raises.

    Runs on ``device`` (default ``cuda``, see :func:`resolve_device`).
    ``stage_times``: a dict to which the ms of the two products
    ("product1", "product2") and the transpose are added; in the tree
    branch "product2" includes the scale, the pin and the cast.  Both
    branches also set "layout_host", the host ms of the plan's kernel
    layouts: the stream's sliced or packed layout or tile plan, or the tree
    levels' compact plans (0 where the kernels run row tiles only, or on the CPU,
    and build none).
    """
    if isinstance(g, DiGraph):
        g = g.in_
    if impl not in ("stream", "tree"):
        raise ValueError(f"unknown impl {impl!r}: 'stream' or 'tree'")
    if impl == "tree" and (spmv_mode, spmv_seg) != ("kahan", 1):
        raise ValueError(
            "spmv_mode and spmv_seg select item-stream kernels; "
            "impl='tree' takes neither"
        )
    device = resolve_device(device)
    clock = _StageClock(stage_times, device)
    if impl == "tree":
        out = _tree_iterate(g, cfg, weighted, dtype, width, col_block, device, clock)
        clock.close()
        return out
    v = g.n_nodes
    if spmv_seg > 1:
        plan = build_spmv_segments(g, weighted=weighted, k=spmv_seg, device=device)
    else:
        plan = build_spmv_stream(g, weighted=weighted, device=device)
    if stage_times is not None:
        built = layout_of(plan)
        stage_times["layout_host"] = built.host_ms if built is not None else 0.0

    s = torch.eye(v, dtype=dtype, device=device)
    for k in range(cfg.iterations):
        pin = None if k == 0 else cfg.c
        ps = clock.stage("product1", spmv, plan, s, spmv_mode, table_scale=pin)
        del s
        pst = clock.stage("transpose", lambda x: x[:v].t().contiguous(), ps)
        del ps
        s = clock.stage("product2", spmv, plan, pst, spmv_mode)  # raw, V+1 rows
        del pst
    clock.close()
    # one scale-pin (c·S, diag 1), then sim(i,i) = 0 (SimRank.java:62-65)
    out = s[:v].float().mul_(cfg.c)
    out.fill_diagonal_(0.0)
    return out.to(dtype)


def _tree_iterate(g, cfg, weighted, dtype, width, col_block, device, clock):
    """The tree branch's loop (graphtpu/simrank/exact.py:429-458)."""
    plan = build_reduction_tree(g, width=width, weighted=weighted, device=device)
    if clock.times is not None:
        clock.times["layout_host"] = plan.layout_host_ms

    def product2(pst):
        out = tree_spmm(plan, pst, col_block).mul_(cfg.c)
        # pin the diagonal to 1 between iterations (SimRank.java:27-30)
        return out.fill_diagonal_(1.0).to(dtype)

    s = torch.eye(g.n_nodes, dtype=dtype, device=device)
    for _ in range(cfg.iterations):
        ps = clock.stage("product1", tree_spmm, plan, s, col_block)  # f32
        del s
        pst = clock.stage("transpose", lambda x: x.t().contiguous(), ps)
        del ps
        s = clock.stage("product2", product2, pst)
        del pst
    return s.fill_diagonal_(0.0)


def weighted_simrank(
    g: Graph, cfg: WeightedSimRankConfig = WeightedSimRankConfig(), **kw
) -> torch.Tensor:
    return exact_simrank(
        g, SimRankConfig(c=cfg.c, iterations=cfg.iterations, topk=cfg.topk),
        weighted=True, **kw,
    )


def simrank_topk(sim: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row descending top-k (values, indices) as numpy (diag already
    zeroed)."""
    vals, idx = topk_rows(sim, k)
    return vals.float().cpu().numpy(), idx.cpu().numpy()


def weighted_simrank_reference_oracle(
    g: Graph, c: float, iterations: int
) -> np.ndarray:
    """Literal numpy port of WeightedSimRank.java:68-93:
    sim'(i,j) = C * sum_{u,v} w(i,u) w(j,v) sim(u,v) / (sum w(i,.) sum w(j,.))
    """
    vcount = g.n_nodes
    rp, col, wh, _ = g.host
    w = np.ones_like(col, np.float64) if wh is None else np.asarray(wh, np.float64)
    sim = np.eye(vcount)
    wsum = np.array([w[rp[i] : rp[i + 1]].sum() for i in range(vcount)])
    for _ in range(iterations):
        new = np.eye(vcount)
        for i in range(vcount):
            for j in range(i + 1, vcount):
                if wsum[i] == 0 or wsum[j] == 0:
                    new[i, j] = new[j, i] = 0.0
                    continue
                ni, wi = col[rp[i] : rp[i + 1]], w[rp[i] : rp[i + 1]]
                nj, wj = col[rp[j] : rp[j + 1]], w[rp[j] : rp[j + 1]]
                val = c * (wi[:, None] * wj[None, :] * sim[np.ix_(ni, nj)]).sum()
                new[i, j] = new[j, i] = val / (wsum[i] * wsum[j])
        sim = new
    np.fill_diagonal(sim, 0.0)
    return sim


def directed_simrank_reference_oracle(
    g: DiGraph, c: float, iterations: int
) -> np.ndarray:
    """Directed SimRank oracle (float64 quadruple loop over in-neighbours):
    sim'(i,j) = C/(|I(i)||I(j)|) * sum_{u in I(i), v in I(j)} sim(u,v)."""
    return exact_simrank_reference_oracle(g.in_, c, iterations)


def exact_simrank_reference_oracle(
    g: Graph, c: float, iterations: int
) -> np.ndarray:
    """Literal numpy port of the SimRank.java quadruple loop — the parity
    oracle for tests (float64, O(V^2 d^2), tiny graphs only)."""
    vcount = g.n_nodes
    rp, col, _, deg = g.host
    sim = np.eye(vcount)
    for _ in range(iterations):
        new = np.eye(vcount)
        for i in range(vcount):
            for j in range(i + 1, vcount):
                if deg[i] == 0 or deg[j] == 0:
                    new[i, j] = new[j, i] = 0.0
                    continue
                ni = col[rp[i] : rp[i + 1]]
                nj = col[rp[j] : rp[j + 1]]
                val = c * sim[np.ix_(ni, nj)].sum() / (deg[i] * deg[j])
                new[i, j] = new[j, i] = val
        sim = new
    np.fill_diagonal(sim, 0.0)
    return sim
