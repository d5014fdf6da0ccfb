"""Sharded sparse SimRank, S' = C·P·S·Pᵀ with S and P partitioned over a
1-D ring of ranks (counterpart of ``graphtpu/dist/spmm_sharded.py``).

* **S is column-sharded**: rank d holds ``S[:, c_d]``, O(V²/n).
* **P is row-sharded**: rank d holds a reduction-tree plan for only its
  row range's CSR, O(E/n) slots (the tree of
  :func:`graphtpu_torch.kernels.spmm.build_reduction_tree`, built per shard
  and padded to a common depth and per-level row counts, as graphtpu pads
  them so one program serves every device).
* **One product P·X is one ring rotation**: at each of n steps, rank d
  multiplies its P rows against the column block in hand, giving the tile
  (P·X)[r_d, c], then passes the block to its ring neighbour
  (:func:`ppermute`).  The local product is graphtpu's ``_tree_apply``
  (spmm_sharded.py:154-168): each level ``out[m] = Σ_j w[m,j]·table[slots[m,j]]``
  with bf16 rows promoted to f32, which is kernel B3's level, so it runs
  :func:`tree_spmm` (B3 on a card, its plain version on the CPU), the
  column panel on a level whose compact plan fits.
* **The transpose is free**: the row block's local transpose is the column
  block the next product needs, and S' is symmetric, so the iteration's
  output row block transposes into the next iteration's input column block
  (:228-233).  Two ring rotations an iteration and no other collective.

``dtype=torch.bfloat16`` keeps bf16 iterates: the ring ships half the
bytes and B3 still accumulates in f32, rounding once per product.

Each rank returns its own column block (:class:`SimBlock`); graphtpu
returns the global array, sharded the same way.  :func:`gather_sim`
assembles the whole matrix on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.graph import Graph, graph_from_numpy, host_csr, pad_graph_nodes
from graphtpu_torch.dist.mesh import all_gather, ppermute
from graphtpu_torch.kernels.spmm import ReductionTree, build_reduction_tree, tree_from_numpy, tree_spmm
from graphtpu_torch.utils.metrics import StageClock


@dataclasses.dataclass(frozen=True)
class SimBlock:
    """A rank's block of the [V, V] result: ``values[i, j]`` is
    S[row_lo + i, col_lo + j]."""

    values: torch.Tensor
    row_lo: int
    col_lo: int
    n_nodes: int


def gather_sim(block: SimBlock) -> torch.Tensor:
    """The whole [V, V] matrix on every rank of the default group, from each
    rank's :class:`SimBlock` (blocks padded to the largest for the gather)."""
    v = block.n_nodes
    dev = block.values.device
    meta = torch.tensor([block.row_lo, block.col_lo, *block.values.shape],
                        dtype=torch.int64, device=dev)
    metas = all_gather(meta, dist.group.WORLD).cpu().tolist()
    hmax = max(m[2] for m in metas)
    wmax = max(m[3] for m in metas)
    pad = torch.zeros((hmax, wmax), dtype=block.values.dtype, device=dev)
    pad[: block.values.shape[0], : block.values.shape[1]] = block.values
    blocks = all_gather(pad, dist.group.WORLD)
    out = torch.zeros((v, v), dtype=block.values.dtype, device=dev)
    for (r0, c0, h, w), b in zip(metas, blocks):
        out[r0: r0 + h, c0: c0 + w] = b[:h, :w]
    return out


def ensure_kernels(mesh) -> None:
    """On a card, build the kernel library once (rank 0) before every rank
    loads it; no-op elsewhere."""
    if mesh.device.type != "cuda":
        return
    from graphtpu_torch.kernels import _build

    if mesh.rank == 0:
        _build.load()
    dist.barrier()
    _build.load()


@dataclasses.dataclass(frozen=True)
class ShardedTreePlan:
    """Per-rank gather-tree plans, stacked on a leading rank axis (host).

    ``levels[k]``: int32[n_dev, M_k, W]; level 0 slots index the GLOBAL row
    space of X (the full column block each rank holds), deeper levels the
    previous level's local output rows.  Every shard is padded to a common
    depth (identity levels) and common per-level row counts (zero-weight
    rows).  ``real_rows[d][k]``: shard d's unpadded rows at level k."""

    levels: Tuple[np.ndarray, ...]
    weights: Tuple[np.ndarray, ...]
    n_nodes: int      # padded global V (divisible by n_dev)
    rows_per: int     # output rows per rank
    n_dev: int
    width: int
    real_rows: Tuple[Tuple[int, ...], ...]

    def local_tree(self, block: int, device) -> ReductionTree:
        """Rank ``block``'s plan as a :class:`ReductionTree` of ``rows_per``
        output rows on ``device`` (with its compact plans on a card)."""
        return tree_from_numpy([l[block] for l in self.levels],
                               [w[block] for w in self.weights], self.width,
                               self.rows_per, self.real_rows[block], device=device)


def _subgraph(g: Graph, lo: int, hi: int) -> Graph:
    """Host-side row-range sub-CSR (rows [lo, hi), global column ids)."""
    rp, col, w, deg = host_csr(g)
    rp = np.asarray(rp).astype(np.int64)
    e_lo, e_hi = int(rp[lo]), int(rp[hi])
    return graph_from_numpy((rp[lo: hi + 1] - rp[lo]).astype(np.int32),
                            np.asarray(col)[e_lo:e_hi],
                            None if w is None else np.asarray(w)[e_lo:e_hi],
                            np.asarray(deg)[lo:hi])


def equalise_trees(trees, width: int):
    """Pad host trees to a common depth with identity levels (slot = own
    row, weight 1) and each level to its largest row count with zero rows;
    returns (levels, weights, real rows), each level stacked on a leading
    axis in ``trees`` order."""
    depth = max(len(t.levels) for t in trees)
    ext = []
    for t in trees:
        levels = [l.cpu().numpy() for l in t.levels]
        weights = [w.cpu().numpy() for w in t.weights]
        real = list(t.real_rows)
        while len(levels) < depth:
            r = real[-1]
            sl = np.zeros((r, width), np.int32)
            sl[:, 0] = np.arange(r)
            wt = np.zeros((r, width), np.float32)
            wt[:, 0] = 1.0
            levels.append(sl)
            weights.append(wt)
            real.append(r)
        ext.append((levels, weights, tuple(real)))
    out_levels, out_weights = [], []
    for k in range(depth):
        mk = max(e[0][k].shape[0] for e in ext)
        ls = np.zeros((len(ext), mk, width), np.int32)
        ws = np.zeros((len(ext), mk, width), np.float32)
        for d, (lv, wt, _) in enumerate(ext):
            ls[d, : lv[k].shape[0]] = lv[k]
            ws[d, : wt[k].shape[0]] = wt[k]
        out_levels.append(ls)
        out_weights.append(ws)
    return tuple(out_levels), tuple(out_weights), tuple(e[2] for e in ext)


def build_sharded_tree_plan(
    g: Graph,
    n_dev: int,
    width: int = 8,
    weighted: bool = False,
) -> ShardedTreePlan:
    """Split P into ``n_dev`` row-range tree plans, equalised and stacked on
    the host; a rank moves only its own block to its device
    (:meth:`ShardedTreePlan.local_tree`)."""
    v = g.n_nodes
    if v % n_dev:
        raise ValueError(f"pad the graph to a multiple of {n_dev} nodes first (V = {v})")
    rows_per = v // n_dev
    trees = [build_reduction_tree(_subgraph(g, d * rows_per, (d + 1) * rows_per),
                                  width=width, weighted=weighted, block=8, device="cpu")
             for d in range(n_dev)]
    levels, weights, real = equalise_trees(trees, width)
    return ShardedTreePlan(levels=levels, weights=weights, n_nodes=v, rows_per=rows_per,
                           n_dev=n_dev, width=width, real_rows=real)


def padded_nodes(v_real: int, mult: int) -> int:
    return -(-v_real // mult) * mult


@dataclasses.dataclass
class ShardedIter:
    """The ring's per-rank programs (graphtpu's ``(plan, v, init, run_n,
    zero_diag)``): ``init()`` is this rank's identity column block
    [V, rows_per], ``run_n(s, n)`` advances it ``n`` iterations and
    ``zero_diag(s)`` zeroes its share of the diagonal."""

    plan: ShardedTreePlan
    v: int
    tree: ReductionTree
    me: int
    group: object
    cfg: SimRankConfig
    dtype: torch.dtype
    stages: StageClock

    @property
    def rows_per(self) -> int:
        return self.plan.rows_per

    def _own(self, s: torch.Tensor) -> torch.Tensor:
        lo = self.me * self.rows_per
        return s[lo: lo + self.rows_per]

    def init(self) -> torch.Tensor:
        s = torch.zeros((self.v, self.rows_per), dtype=self.dtype, device=self.tree.levels[0].device)
        self._own(s).fill_diagonal_(1.0)
        return s

    def zero_diag(self, s: torch.Tensor) -> torch.Tensor:
        self._own(s).fill_diagonal_(0.0)
        return s

    def ring_product(self, x_blk: torch.Tensor) -> torch.Tensor:
        """P·X from X's column blocks: this rank's row block (P·X)[r_me, :]
        from n rotate-and-multiply steps (the last block is not passed on)."""
        n, rp = self.plan.n_dev, self.rows_per
        y = torch.empty((rp, self.v), dtype=x_blk.dtype, device=x_blk.device)
        blk = x_blk
        for k in range(n):
            c = (self.me + k) % n  # the block in hand started at rank me + k
            tile = self.stages.stage("b3", tree_spmm, self.tree, blk)
            y[:, c * rp: (c + 1) * rp] = tile
            if k + 1 < n:
                blk = self.stages.stage("wire", ppermute, blk, self.group)
        return y

    def one_iter(self, s_blk: torch.Tensor) -> torch.Tensor:
        ps_rows = self.ring_product(s_blk)                     # (P·S)[r_me, :]
        z_blk = self.stages.stage("local", lambda x: x.t().contiguous(), ps_rows)
        del ps_rows
        # graphtpu's weak-typed c takes the iterate's dtype
        c = torch.tensor(self.cfg.c, dtype=self.dtype, device=z_blk.device)
        out_rows = self.ring_product(z_blk) * c               # C·(P·(P·S)ᵀ)[r_me, :]
        del z_blk
        # pin the diagonal: row i of the block is global row me*rows_per + i
        lo = self.me * self.rows_per
        out_rows[:, lo: lo + self.rows_per].fill_diagonal_(1.0)
        # S' is symmetric: the output ROW block transposed is the next input
        # COLUMN block
        return self.stages.stage("local", lambda x: x.t().contiguous(), out_rows)

    def run_n(self, s: torch.Tensor, n_iters: int) -> torch.Tensor:
        for _ in range(n_iters):
            s = self.one_iter(s)
        return s


def make_sharded_iter(
    g: Graph,
    mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[ShardedTreePlan] = None,
    dtype=torch.float32,
    stage_times: Optional[dict] = None,
) -> ShardedIter:
    """The ring's programs on this rank of the 1-D ``mesh``.  V is padded to
    a multiple of 128·n with isolated nodes.  ``stage_times``: a dict to
    which the ms of building this rank's plan ("plan": the host trees, the
    compact plans and the copy to the device), the local products ("b3"),
    the ring shifts ("wire") and the local transposes ("local") are added
    (the device synchronised around each)."""
    n_dev = mesh.size
    stages = StageClock(stage_times, mesh.device, sync=True)
    v = padded_nodes(g.n_nodes, 128 * n_dev)
    if plan is None:
        gp = pad_graph_nodes(g, v) if v != g.n_nodes else g
        plan = stages.stage("plan", build_sharded_tree_plan, gp, n_dev, width=width,
                            weighted=weighted)
    ensure_kernels(mesh)
    return ShardedIter(plan=plan, v=v, tree=stages.stage("plan", plan.local_tree, mesh.coords[0],
                                                         mesh.device),
                       me=mesh.coords[0], group=mesh.groups[mesh.axis_names[0]], cfg=cfg,
                       dtype=dtype, stages=stages)


def sharded_simrank_spmm(
    g: Graph,
    mesh,
    cfg: SimRankConfig = SimRankConfig(),
    weighted: bool = False,
    width: int = 8,
    plan: Optional[ShardedTreePlan] = None,
    dtype=torch.float32,
    stage_times: Optional[dict] = None,
) -> SimBlock:
    """Exact SimRank, sparse products, S sharded over the 1-D ``mesh``.

    Same fixed point as ``exact_simrank_spmm`` (diag pinned during
    iteration, zeroed after, ``SimRank.java:27-30,62-65``), but no rank
    holds more than a [V, V/n] block of S or an O(E/n) slice of P.  Returns
    this rank's column block of the [V, V] result in ``dtype``."""
    it = make_sharded_iter(g, mesh, cfg, weighted=weighted, width=width, plan=plan, dtype=dtype,
                           stage_times=stage_times)
    s = it.zero_diag(it.run_n(it.init(), cfg.iterations))
    v_real = g.n_nodes
    lo = it.me * it.rows_per
    return SimBlock(values=s[:v_real, : max(0, min(it.rows_per, v_real - lo))],
                    row_lo=0, col_lo=lo, n_nodes=v_real)
