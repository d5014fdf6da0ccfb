"""Graph relabeling for gather locality (counterpart of ``graphtpu/core/reorder.py``).

A locality-improving relabeling makes consecutive CSR slots reference
adjacent rows, which the coalesced k-row stream
(:func:`graphtpu_torch.kernels.spmm.build_spmv_segments`) turns into fewer,
longer row reads.  All orders are host-side numpy passes; ``relabel_graph``
permutes at the CSR slot level, keeping weights and multiplicity exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from graphtpu_torch.core.graph import Graph, graph_from_numpy


def bfs_order(g: Graph, start: Optional[int] = None) -> np.ndarray:
    """int32[V] permutation ``order[new_id] = old_id`` from a BFS that
    visits neighbours in increasing-degree order (Cuthill-McKee), seeded at
    ``start`` when it is given, then restarting at the lowest-degree
    unvisited node per component."""
    rp, col, _, deg = g.host
    v = g.n_nodes
    order = np.empty(v, np.int64)
    seen = np.zeros(v, bool)
    pos = 0
    seeds = np.argsort(deg, kind="stable")
    if start is not None:
        seeds = np.concatenate([[start], seeds])
    head = 0
    for s in seeds:
        if seen[s]:
            continue
        seen[s] = True
        order[pos] = s
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = np.unique(col[rp[u] : rp[u + 1]])
            nbrs = nbrs[~seen[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                seen[nbrs] = True
                order[pos : pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    assert pos == v, (pos, v)
    return order.astype(np.int32)


def degree_order(g: Graph) -> np.ndarray:
    """int32[V] permutation: hubs first (stable)."""
    return np.argsort(-g.host[3], kind="stable").astype(np.int32)


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee through scipy's C implementation."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rp, col, _, _ = g.host
    v = g.n_nodes
    m = csr_matrix((np.ones(len(col), np.int8), col, rp), shape=(v, v))
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True), np.int32)


def relabel_graph(g: Graph, order: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Apply ``order[new_id] = old_id``; returns ``(g2, inv)`` with
    ``inv[old_id] = new_id`` (use it to map results back)."""
    rp, col, w, deg = g.host
    v = g.n_nodes
    order = np.asarray(order, np.int64)
    inv = np.empty(v, np.int64)
    inv[order] = np.arange(v)

    new_deg = deg[order]
    new_rp = np.zeros(v + 1, np.int64)
    np.cumsum(new_deg, out=new_rp[1:])
    # stable-sort every edge by (new row, new neighbour)
    row_of_e = np.repeat(np.arange(v), np.diff(rp))
    new_row = inv[row_of_e]
    new_nb = inv[col.astype(np.int64)]
    perm = np.lexsort((new_nb, new_row))
    g2 = graph_from_numpy(
        new_rp.astype(np.int32),
        new_nb[perm].astype(np.int32),
        None if w is None else w[perm],
        new_deg.astype(np.int32),
        device=g.device,
    )
    return g2, inv.astype(np.int32)


def locality_score(g: Graph, window: int = 1) -> float:
    """Fraction of consecutive CSR slots whose neighbour ids differ by at
    most ``window``: at 1, the share of items a k-row segment stream could
    merge."""
    col = g.host[1]
    if len(col) < 2:
        return 0.0
    d = np.abs(np.diff(col.astype(np.int64)))
    return float((d <= window).mean())
