"""Batched neighbour sampling over CSR (counterpart of
``graphtpu/kernels/sampling.py``): the walk engine's inner operations.

* uniform: one neighbour per walker, -1 at dead ends (the reference's
  ``Graph.randNeighbor``, ``Graph.java:69-73``);
* weighted: a fixed-step bisection of each row's cumulative weights
  (``WGraph.randNeighborByWeight``, ``WGraph.java:89-105``);
* membership: a bisection of u's sorted row (``G.has_edge``,
  ``node2vec/src/node2vec.py:73``).

Batch-first: ``cur`` is an int32 [B] (or [B, K]) frontier and the ops run
where it lies.  Dead and invalid walkers (``cur < 0``, or a degree-0 node)
give -1.  Node ids are int32 in and out.
"""

from __future__ import annotations

import math

import torch

from graphtpu_torch.core.graph import Graph


def _bisect_steps(max_degree: int) -> int:
    return max(1, math.ceil(math.log2(max(2, max_degree))) + 1)


def row_spans(g: Graph, cur: torch.Tensor):
    """(safe index, degree, row start) of each walker's row.  A degree-0
    row may start at E; its start is clamped into ``col`` (torch indexing
    does not clamp, as XLA's gathers do), and its result is masked."""
    safe = cur.clamp(min=0).long()
    lo = g.row_ptr[safe].long().clamp(max=max(g.n_edges - 1, 0))
    return safe, g.deg[safe], lo


def uniform_neighbor(g: Graph, cur: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One uniform neighbour per walker; -1 for dead/invalid walkers."""
    return neighbor_at(g, cur, torch.rand(cur.shape, generator=gen, device=cur.device))


def neighbor_at(g: Graph, cur: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The neighbour of each walker's row at its uniform draw ``u`` in [0, 1)
    (position floor(u * degree), kept inside the row); -1 for dead/invalid
    walkers."""
    _, deg, lo = row_spans(g, cur)
    idx = torch.minimum((u * deg).int(), (deg - 1).clamp(min=0))
    nxt = g.col[lo + idx]
    alive = (cur >= 0) & (deg > 0)
    return torch.where(alive, nxt, -1)


def row_cumulative_weights(g: Graph) -> torch.Tensor:
    """float32[E]: within-row cumulative weights (unnormalised).

    graphtpu takes one float32 prefix sum over all E weights and subtracts
    each row's base, so a row's sums carry rounding of the whole graph's
    total; this takes the prefix sum in float64, so each value is its row's
    sum rounded once to float32."""
    w = g.weight if g.weight is not None else torch.ones_like(g.col, dtype=torch.float32)
    csum = torch.cumsum(w.double(), 0)
    row_base = torch.cat([csum.new_zeros(1), csum])[g.row_ptr[:-1].long()]
    starts = torch.repeat_interleave(row_base, g.deg.long(), output_size=g.n_edges)
    return (csum - starts).float()


def weighted_neighbor(
    g: Graph, cumw: torch.Tensor, cur: torch.Tensor, gen: torch.Generator
) -> torch.Tensor:
    """One weight-proportional neighbour per walker via row bisection."""
    _, deg, lo = row_spans(g, cur)
    last = (deg - 1).clamp(min=0)
    total = cumw[lo + last]
    u = torch.rand(cur.shape, generator=gen, device=cur.device) * total
    # the first position in [lo, lo+deg) with cumw >= u
    lo_i = torch.zeros_like(deg)
    hi_i = deg
    for _ in range(_bisect_steps(g.max_degree)):
        mid = (lo_i + hi_i) // 2
        go_right = cumw[lo + torch.minimum(mid, last)] < u
        lo_i = torch.where(go_right, mid + 1, lo_i)
        hi_i = torch.where(go_right, hi_i, mid)
    nxt = g.col[lo + torch.minimum(lo_i, last)]
    alive = (cur >= 0) & (deg > 0)
    return torch.where(alive, nxt, -1)


def edge_exists(g: Graph, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bool per pair (broadcasting): is v a neighbour of u?  Bisection over
    u's sorted row."""
    u, v = torch.broadcast_tensors(u, v)
    _, deg, lo = row_spans(g, u)
    last = (deg - 1).clamp(min=0)
    lo_i = torch.zeros_like(deg)
    hi_i = deg
    for _ in range(_bisect_steps(g.max_degree)):
        mid = (lo_i + hi_i) // 2
        go_right = g.col[lo + torch.minimum(mid, last)] < v
        lo_i = torch.where(go_right, mid + 1, lo_i)
        hi_i = torch.where(go_right, hi_i, mid)
    found = g.col[lo + torch.minimum(lo_i, last)]
    return (found == v) & (lo_i < deg) & (deg > 0) & (u >= 0)


def sample_from_cdf(cdf: torch.Tensor, gen: torch.Generator, shape) -> torch.Tensor:
    """int32 draws ~ categorical given an (unnormalised) 1-D cdf."""
    u = torch.rand(shape, generator=gen, device=cdf.device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).int()
