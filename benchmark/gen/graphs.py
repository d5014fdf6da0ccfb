"""Frozen graph generators of the benchmark (numpy, deterministic per seed).

``uniform_pairs`` and ``rmat`` are copies of the draws of
``graphtpu_torch.bench.generators.blog_shaped_edges`` and ``rmat_graph``
at the time the benchmark was defined, kept here so that a change to the
program cannot change the yardstick's traffic.  ``urand`` and ``kron``
shape them as the public benchmarks define their graphs.  A configuration
names one of :data:`GENERATORS` and its parameters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def uniform_pairs(seed: int, nodes: int, pairs: int) -> np.ndarray:
    """``pairs`` uniform random (u, v) pairs on ``nodes`` nodes, self-pairs
    kept."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, nodes, size=(pairs, 2)).astype(np.int64)


def rmat(seed: int, scale: int, draws: int,
         p: Sequence[float] = (0.57, 0.19, 0.19, 0.05)) -> np.ndarray:
    """R-MAT recursive-quadrant draws on 2^scale nodes with quadrant
    probabilities (pA, pB, pC, pD) at each level; self-loops dropped."""
    rng = np.random.default_rng(seed)
    pa, pb, pc, pd = p
    src = np.zeros(draws, dtype=np.int64)
    dst = np.zeros(draws, dtype=np.int64)
    for _ in range(scale):
        u = rng.random(draws)
        row_bit = (u >= pa + pb).astype(np.int64)
        u2 = np.where(u < pa + pb, u / (pa + pb), (u - pa - pb) / (pc + pd))
        col_threshold = np.where(u < pa + pb, pa / (pa + pb), pc / (pc + pd))
        col_bit = (u2 >= col_threshold).astype(np.int64)
        src = (src << 1) | row_bit
        dst = (dst << 1) | col_bit
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)


def urand(seed: int, scale: int, edge_factor: int) -> np.ndarray:
    """GAP's uniform random graph (Erdős–Rényi): edge_factor·2^scale
    uniform pairs on 2^scale nodes, self-loops dropped as GAP's builder
    drops them."""
    e = uniform_pairs(seed, 1 << scale, edge_factor << scale)
    return e[e[:, 0] != e[:, 1]]


def kron(seed: int, scale: int, edge_factor: int, initiator: Sequence[float]) -> np.ndarray:
    """Graph500's Kronecker graph: edge_factor·2^scale R-MAT draws with the
    initiator's quadrant probabilities, self-loops dropped, then the vertex
    labels permuted at random (the specification's step against the
    generator's locality)."""
    e = rmat(seed, scale, edge_factor << scale, initiator)
    perm = np.random.default_rng([seed, 1]).permutation(1 << scale)
    return perm[e]


GENERATORS = {"urand": urand, "kron": kron}


def edges_of(graph: dict, seed: int) -> np.ndarray:
    """The edges of a configuration's ``graph`` block at ``seed``: the
    generator it names, called with its other keys except ``n_nodes``."""
    params = {k: v for k, v in graph.items() if k not in ("generator", "n_nodes")}
    return GENERATORS[graph["generator"]](seed, **params)
