"""Synthetic graph generators (numpy, deterministic given a seed).

The generators of ``graphtpu/bench/generators.py``, with its semantics:
uniform random pairs, bipartite, directed and R-MAT power-law graphs, and
the streamed, deduplicated bipartite writer for huge V; and the graphs
the port's checks run at full width, :func:`blog_shaped_graph`,
:func:`rmat14_graph`, :func:`arxiv_shaped_graph` and :func:`v60000_graph`.
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


def directed_random_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> np.ndarray:
    """n*avg_degree directed pairs with uniform endpoints, self-loops
    skipped."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree
    edges = rng.integers(0, n_nodes, size=(int(m * 1.1), 2), dtype=np.int64)
    return edges[edges[:, 0] != edges[:, 1]][:m]


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


def massive_bipartite_graph(
    n_left: int,
    n_right: int,
    avg_degree: int,
    out_path: str,
    seed: int = 0,
    chunk: int = 2_000_000,
    use_native: bool = True,
) -> int:
    """Stream (n_left + n_right) * avg_degree / 2 distinct bipartite edges
    to ``out_path`` (right ids offset by n_left; ``GraphGeneratorBf``'s
    role); returns the edges written.  ``use_native`` picks the
    multithreaded C++ generator with Bloom dedup
    (:func:`graphtpu_torch.native.generate_graph`), else the exact numpy
    dedup by a rolling sorted key set, ``chunk`` draws at a time, which
    gives graphtpu's file for the same seed."""
    target = (n_left + n_right) * avg_degree // 2
    if use_native:
        from graphtpu_torch.native import generate_graph

        return generate_graph(out_path, "bipartite", n_left, n_right, target, seed=seed)
    rng = np.random.default_rng(seed)
    seen = np.empty(0, dtype=np.uint64)
    written = 0
    with open(out_path, "w") as f:
        while written < target:
            m = min(chunk, target - written + chunk // 4)
            src = rng.integers(0, n_left, size=m, dtype=np.uint64)
            dst = rng.integers(0, n_right, size=m, dtype=np.uint64)
            key_u = np.unique(src * np.uint64(n_right) + dst)
            fresh = key_u[~np.isin(key_u, seen, assume_unique=True)][: target - written]
            seen = np.union1d(seen, fresh)
            s = (fresh // np.uint64(n_right)).astype(np.int64)
            d = (fresh % np.uint64(n_right)).astype(np.int64) + n_left
            f.writelines(f"{a} {b}\n" for a, b in zip(s, d))
            written += len(fresh)
    return written


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


ARXIV_LEFT = ARXIV_RIGHT = 19_456
ARXIV_NODES = ARXIV_LEFT + ARXIV_RIGHT


def arxiv_shaped_edges(seed: int = 0) -> np.ndarray:
    """The arxiv author-publication shape (``examples/arxiv_simrank.py``):
    a bipartite graph of 19,456 + 19,456 nodes at average degree 3."""
    return bipartite_random_graph(ARXIV_LEFT, ARXIV_RIGHT, 3, seed=seed)


def arxiv_shaped_graph(seed: int = 0, device="cpu"):
    """The arxiv-shaped graph: V = 38,912, 116,722 CSR slots at seed 0,
    degrees up to 13."""
    return build_graph(arxiv_shaped_edges(seed), n_nodes=ARXIV_NODES, device=device)


V60000_NODES = 60_000


def v60000_graph(seed: int = 4, device="cpu"):
    """V = 60,000 (past one block's shared memory): 200,000 random edges
    and a hub of degree 3,000 at node 7."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, V60000_NODES, size=(200_000, 2))
    hub = np.stack([np.full(3000, 7), rng.choice(V60000_NODES, 3000, replace=False)], 1)
    return build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]),
                       n_nodes=V60000_NODES, device=device)
