"""Synthetic graph generators (numpy, deterministic given a seed).

The three generators the port's checks need, with the semantics of
``graphtpu/bench/generators.py``: uniform random pairs, bipartite, and
R-MAT power-law graphs; and the two graphs the port's checks run at full
width, :func:`blog_shaped_graph` and :func:`rmat14_graph`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from graphtpu_torch.core.graph import build_graph


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


BLOG_NODES = 10_496


def blog_shaped_edges(seed: int = 0) -> np.ndarray:
    """bench.py's stand-in for the BlogCatalog graph: 330,000 uniform random
    pairs on 10,240 nodes (bench.py:184-186); build it with
    ``n_nodes=BLOG_NODES``, which pads with isolated nodes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 10240, size=(330_000, 2)).astype(np.int64)


def blog_shaped_graph(seed: int = 0, device="cpu"):
    """The blog-shaped graph: V = 10,496, 657,924 CSR slots at seed 0."""
    return build_graph(blog_shaped_edges(seed), n_nodes=BLOG_NODES, device=device)


RMAT14_NODES = 1 << 14


def rmat14_edges(seed: int = 0) -> np.ndarray:
    """R-MAT at scale 14 with 330,000 edges (self-loops dropped)."""
    return rmat_graph(scale=14, n_edges=330_000, seed=seed)


def rmat14_graph(seed: int = 0, device="cpu"):
    """The R-MAT graph: V = 16,384, degrees skewed up to 4,086 at seed 0."""
    return build_graph(rmat14_edges(seed), n_nodes=RMAT14_NODES, device=device)
