"""2-D SUMMA sharded sparse SimRank, S' = C·P·S·Pᵀ on an r×c grid of
ranks (counterpart of ``graphtpu/dist/spmm_summa.py``).

The 1-D ring (:mod:`graphtpu_torch.dist.spmm_sharded`) ships each rank's
column block around the whole ring, ~V² bytes a rank a product.  The 2-D
decomposition cuts that to ~V²·(1/r + 1/c):

* **Mesh**: an (r, c) grid, axes ("pr", "pc") (:func:`make_2d_mesh`).
* **P is 2-D block-partitioned and static**: rank (i, j) holds a tree plan
  for the sub-CSR of rows ``r_i`` and columns ``kc_j``, column ids local
  to its k-block, normalised by the GLOBAL row sums
  (``build_reduction_tree(row_scale=...)``).
* **S lives in a transposed block layout**: rank (i, j) holds
  ``S[kc_j, cr_i]``, a [V/c, V/r] block.
* **One product P·X is r ring steps along "pr"**: at step t rank (i, j)
  multiplies its plan against the X block in hand (through
  :func:`tree_spmm`: kernel B3 on a card), giving k-block j's partial of
  ``(P·X)[r_i, cr_m]`` with m = (i+t) mod r; :func:`psum_scatter` along
  "pc" sums the c partials and leaves each rank a 1/c row strip, and the X
  block shifts along "pr".
* **The layout transpose is one all_to_all along "pc"**: row strips
  regroup into ``Yᵀ`` blocks in the layout the next product reads; S' is
  symmetric, so the iteration's output re-enters directly.

With bf16 iterates the reduce and the transpose ship bf16; the strips and
the sums stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.graph import DiGraph, Graph, graph_from_numpy, host_csr, pad_graph_nodes
from graphtpu_torch.dist.mesh import all_to_all, make_2d_mesh, ppermute, psum_scatter
from graphtpu_torch.dist.spmm_sharded import (
    SimBlock,
    ensure_kernels,
    equalise_trees,
    padded_nodes,
)
from graphtpu_torch.kernels.spmm import ReductionTree, build_reduction_tree, tree_from_numpy, tree_spmm
from graphtpu_torch.utils.metrics import StageClock

__all__ = ["SummaPlan", "build_summa_plan", "make_2d_mesh", "make_summa_iter",
           "summa_simrank_spmm"]


@dataclasses.dataclass(frozen=True)
class SummaPlan:
    """Per-rank 2-D block tree plans, stacked on (r, c) leading axes (host).

    ``levels[k]``: int32[r, c, M_k, W]; level 0 slots index the LOCAL rows
    of the k-block in hand (0..V/c), deeper levels the previous level's
    outputs.  All r·c blocks are padded to a common depth and per-level row
    counts.  ``real_rows[i*c + j][k]``: block (i, j)'s unpadded rows."""

    levels: Tuple[np.ndarray, ...]
    weights: Tuple[np.ndarray, ...]
    n_nodes: int
    r: int
    c: int
    width: int
    real_rows: Tuple[Tuple[int, ...], ...]

    def local_tree(self, i: int, j: int, device) -> ReductionTree:
        """Block (i, j)'s plan as a :class:`ReductionTree` of V/r output rows."""
        return tree_from_numpy([l[i, j] for l in self.levels], [w[i, j] for w in self.weights],
                               self.width, self.n_nodes // self.r,
                               self.real_rows[i * self.c + j], device=device)


def _block_graph(rp, col, w, row_lo, row_hi, col_lo, col_hi) -> Graph:
    """Sub-CSR of rows [row_lo, row_hi) restricted to columns
    [col_lo, col_hi), column ids rebased to the block."""
    e_lo, e_hi = int(rp[row_lo]), int(rp[row_hi])
    cb = col[e_lo:e_hi]
    keep = (cb >= col_lo) & (cb < col_hi)
    row_of = np.repeat(np.arange(row_hi - row_lo), np.diff(rp[row_lo: row_hi + 1]))
    cnt = np.zeros(row_hi - row_lo, np.int64)
    np.add.at(cnt, row_of[keep], 1)
    rp_b = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    return graph_from_numpy(rp_b, (cb[keep] - col_lo).astype(np.int32),
                            None if w is None else w[e_lo:e_hi][keep], cnt.astype(np.int32))


def build_summa_plan(
    g: Graph,
    r: int,
    c: int,
    width: int = 8,
    weighted: bool = False,
) -> SummaPlan:
    """2-D block tree plans with GLOBAL row normalisation, equalised and
    stacked [r, c, ...] on the host; a rank moves only its own block to its
    device (:meth:`SummaPlan.local_tree`)."""
    v = g.n_nodes
    if v % (r * c):
        raise ValueError(f"pad the graph to a multiple of {r * c} nodes first (V = {v})")
    rows_per, kc = v // r, v // c
    rp_h, col_h, w_h, _ = host_csr(g)
    rp = np.asarray(rp_h).astype(np.int64)
    col = np.asarray(col_h).astype(np.int64)
    w = np.asarray(w_h, np.float32) if (weighted and w_h is not None) else None
    # the global 1/Σw row scale (column-restricted blocks see partial sums)
    wsrc = w if w is not None else np.ones(len(col), np.float32)
    denom = np.zeros(v, np.float64)
    np.add.at(denom, np.repeat(np.arange(v), np.diff(rp)), wsrc)
    gscale = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0).astype(np.float32)

    trees = []
    for i in range(r):
        row_lo, row_hi = i * rows_per, (i + 1) * rows_per
        for j in range(c):
            sub = _block_graph(rp, col, w, row_lo, row_hi, j * kc, (j + 1) * kc)
            trees.append(build_reduction_tree(sub, width=width, weighted=weighted, block=8,
                                              row_scale=gscale[row_lo:row_hi], device="cpu"))
    levels, weights, real = equalise_trees(trees, width)
    return SummaPlan(levels=tuple(l.reshape(r, c, *l.shape[1:]) for l in levels),
                     weights=tuple(x.reshape(r, c, *x.shape[1:]) for x in weights),
                     n_nodes=v, r=r, c=c, width=width, real_rows=real)


@dataclasses.dataclass
class SummaIter:
    """The grid's per-rank programs, the contract of
    :class:`graphtpu_torch.dist.spmm_sharded.ShardedIter`, S carried as this
    rank's transposed block ``S[kc_j, cr_i]`` [V/c, V/r]."""

    plan: SummaPlan
    v: int
    tree: ReductionTree
    mi: int
    mj: int
    pr: object
    pc: object
    cfg: SimRankConfig
    dtype: torch.dtype
    stages: StageClock

    @property
    def rows_per(self) -> int:
        return self.v // self.plan.r

    @property
    def kc(self) -> int:
        return self.v // self.plan.c

    def _diag_mask(self, s: torch.Tensor):
        """The diagonal entries of the block: global row mj*kc + a equals
        global column mi*rows_per + b."""
        a = self.mj * self.kc + torch.arange(self.kc, device=s.device)[:, None]
        b = self.mi * self.rows_per + torch.arange(self.rows_per, device=s.device)[None, :]
        return a == b

    def init(self) -> torch.Tensor:
        dev = self.tree.levels[0].device
        s = torch.zeros((self.kc, self.rows_per), dtype=self.dtype, device=dev)
        return s.masked_fill_(self._diag_mask(s), 1.0)

    def zero_diag(self, s: torch.Tensor) -> torch.Tensor:
        return s.masked_fill_(self._diag_mask(s), 0.0)

    def ring_product(self, x_blk: torch.Tensor) -> torch.Tensor:
        """P·X row strips: [strip, V] = (P·X)[strip(mi, mj), :], f32."""
        r, rp = self.plan.r, self.rows_per
        strip = rp // self.plan.c
        y = torch.empty((strip, self.v), dtype=torch.float32, device=x_blk.device)
        blk = x_blk
        for t in range(r):
            m = (self.mi + t) % r  # the column block in hand
            w_full = self.stages.stage("b3", tree_spmm, self.tree, blk)
            # sum the c k-block partials, each rank keeping 1/c of the rows,
            # in the block's dtype on the wire
            y[:, m * rp: (m + 1) * rp] = self.stages.stage(
                "wire", psum_scatter, w_full.to(x_blk.dtype), self.pc)
            del w_full
            if t + 1 < r:
                blk = self.stages.stage("wire", ppermute, blk, self.pr)
        return y

    def strip_to_input(self, y: torch.Tensor) -> torch.Tensor:
        """[strip, V] row strips -> the [V/c, V/r] transposed block: one
        all_to_all along "pc" (V²/n bytes a rank)."""
        c, kc = self.plan.c, self.kc
        send = y.to(self.dtype).reshape(y.shape[0], c, kc).transpose(0, 1)  # [c, strip, kc]
        recv = self.stages.stage("wire", all_to_all, send.contiguous(), self.pc)  # Y[cr_mi, kc_mj]
        return self.stages.stage("local", lambda x: x.reshape(-1, kc).t().contiguous(), recv)

    def one_iter(self, s_blk: torch.Tensor) -> torch.Tensor:
        z = self.strip_to_input(self.ring_product(s_blk))        # (P·S)ᵀ blocks
        out = self.ring_product(z) * self.cfg.c                  # C·P·(P·S)ᵀ strips, f32
        del z
        # pin the diagonal: strip row q is global row mi*rows_per + mj*strip + q
        strip = out.shape[0]
        lo = self.mi * self.rows_per + self.mj * strip
        out[:, lo: lo + strip].fill_diagonal_(1.0)
        # S' is symmetric: its transposed-layout blocks are the next input
        return self.strip_to_input(out)

    def run_n(self, s: torch.Tensor, n_iters: int) -> torch.Tensor:
        for _ in range(n_iters):
            s = self.one_iter(s)
        return s


def make_summa_iter(
    g: Graph,
    mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[SummaPlan] = None,
    dtype=torch.float32,
    stage_times: Optional[dict] = None,
) -> SummaIter:
    """The 2-D programs on this rank of the ("pr", "pc") ``mesh``; V is
    padded to a multiple of 8·r·c.  ``stage_times`` as in
    :func:`graphtpu_torch.dist.spmm_sharded.make_sharded_iter`."""
    if tuple(mesh.axis_names) != ("pr", "pc"):
        raise ValueError(f"SUMMA needs a ('pr', 'pc') mesh, got {mesh.axis_names}")
    r, c = mesh.shape
    stages = StageClock(stage_times, mesh.device, sync=True)
    v = padded_nodes(g.n_nodes, r * c * 8)
    if plan is None:
        gp = pad_graph_nodes(g, v) if v != g.n_nodes else g
        plan = stages.stage("plan", build_summa_plan, gp, r, c, width=width, weighted=weighted)
    ensure_kernels(mesh)
    mi, mj = mesh.coords
    return SummaIter(plan=plan, v=v,
                     tree=stages.stage("plan", plan.local_tree, mi, mj, mesh.device),
                     mi=mi, mj=mj, pr=mesh.groups["pr"], pc=mesh.groups["pc"], cfg=cfg,
                     dtype=dtype, stages=stages)


def summa_simrank_spmm(
    g: Graph,
    mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[SummaPlan] = None,
    dtype=torch.float32,
    stage_times: Optional[dict] = None,
) -> SimBlock:
    """Exact SimRank on the 2-D grid; same fixed point as
    ``exact_simrank_spmm`` (diag pinned during iteration, zeroed after;
    ``SimRank.java:27-30,62-65``).  A :class:`DiGraph` runs over its
    in-neighbour rows.  Returns this rank's block ``S[kc_j, cr_i]`` of the
    [V, V] result in ``dtype``."""
    if isinstance(g, DiGraph):
        g = g.in_  # sim flows along incoming edges (structures/DGraph.java)
    it = make_summa_iter(g, mesh, cfg, weighted=weighted, width=width, plan=plan, dtype=dtype,
                         stage_times=stage_times)
    s = it.zero_diag(it.run_n(it.init(), cfg.iterations))
    v_real = g.n_nodes
    r0, c0 = it.mj * it.kc, it.mi * it.rows_per
    h = max(0, min(it.kc, v_real - r0))
    w = max(0, min(it.rows_per, v_real - c0))
    return SimBlock(values=s[:h, :w], row_lo=r0, col_lo=c0, n_nodes=v_real)
