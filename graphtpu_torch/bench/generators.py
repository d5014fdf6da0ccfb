"""Synthetic graph generators (numpy, deterministic given a seed).

The three generators the port's checks need, with the semantics of
``graphtpu/bench/generators.py``: uniform random pairs, bipartite, and
R-MAT power-law graphs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def uniform_random_graph(
    n_nodes: int, avg_degree: int, seed: int = 0, dedup: bool = True
) -> np.ndarray:
    """~n*avg_degree/2 undirected edges with uniform endpoints, self-loops
    skipped."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree // 2
    edges = rng.integers(0, n_nodes, size=(int(m * 1.2), 2), dtype=np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]][:m]
    if dedup:
        key = np.minimum(edges[:, 0], edges[:, 1]) * n_nodes + np.maximum(
            edges[:, 0], edges[:, 1]
        )
        _, idx = np.unique(key, return_index=True)
        edges = edges[np.sort(idx)]
    return edges


def bipartite_random_graph(
    n_left: int, n_right: int, avg_degree: int, seed: int = 0
) -> np.ndarray:
    """Left ids [0, n_left), right ids [n_left, n_left+n_right)."""
    rng = np.random.default_rng(seed)
    m = (n_left + n_right) * avg_degree // 2
    src = rng.integers(0, n_left, size=m, dtype=np.int64)
    dst = rng.integers(0, n_right, size=m, dtype=np.int64) + n_left
    return np.stack([src, dst], axis=1)


def rmat_graph(
    scale: int,
    n_edges: int,
    p: Tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05),
    seed: int = 0,
    bipartite_offset: bool = False,
) -> np.ndarray:
    """R-MAT recursive-quadrant generator: 2^scale vertices, quadrant
    probabilities (pA, pB, pC, pD) at each of ``scale`` levels; self-loops
    dropped.  ``bipartite_offset`` shifts destination ids by 2^scale."""
    rng = np.random.default_rng(seed)
    pa, pb, pc, pd = p
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for _ in range(scale):
        u = rng.random(n_edges)
        row_bit = (u >= pa + pb).astype(np.int64)
        u2 = np.where(u < pa + pb, u / (pa + pb), (u - pa - pb) / (pc + pd))
        col_threshold = np.where(u < pa + pb, pa / (pa + pb), pc / (pc + pd))
        col_bit = (u2 >= col_threshold).astype(np.int64)
        src = (src << 1) | row_bit
        dst = (dst << 1) | col_bit
    if bipartite_offset:
        dst = dst + (1 << scale)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)
