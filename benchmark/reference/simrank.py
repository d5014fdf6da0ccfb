"""Plain exact SimRank in float64: the benchmark's reference.

Builds the row-stochastic adjacency P of the undirected graph from the
edges itself (each pair mirrored, duplicates collapsed, a self-pair one
entry, an isolated node an empty row) and iterates, from S = I,

    S <- C·P·S·Pᵀ, then the diagonal pinned to 1,

zeroing the diagonal at the end (the reference's ``SimRank.java:27-65``).
Plain PyTorch sparse-dense products; it imports nothing of the program.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def transition(edges: np.ndarray, n_nodes: int, device) -> torch.Tensor:
    """P as a float64 [V, V] CSR tensor on ``device``: P[i, j] = 1/deg(i)
    for each distinct neighbour j of i."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    key = np.unique(src * n_nodes + dst)
    rows, cols = key // n_nodes, key % n_nodes
    deg = np.bincount(rows, minlength=n_nodes)
    crow = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=crow[1:])
    vals = 1.0 / deg[rows]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.tensor(crow, device=device), torch.tensor(cols, device=device),
            torch.tensor(vals, dtype=torch.float64, device=device), (n_nodes, n_nodes),
            check_invariants=False)


def nnz(edges: np.ndarray, n_nodes: int) -> int:
    """Nonzeros of P: the distinct (row, column) pairs of the mirrored edges."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    key = np.concatenate([e[:, 0] * n_nodes + e[:, 1], e[:, 1] * n_nodes + e[:, 0]])
    return int(np.unique(key).size)


def simrank(edges: np.ndarray, n_nodes: int, c: float, iterations: int, device) -> torch.Tensor:
    """Dense float64 [V, V] SimRank scores after ``iterations`` steps, the
    diagonal zeroed."""
    p = transition(edges, n_nodes, device)
    s = torch.eye(n_nodes, dtype=torch.float64, device=device)
    for _ in range(iterations):
        ps = torch.sparse.mm(p, s)
        del s
        pst = ps.t().contiguous()
        del ps
        s = torch.sparse.mm(p, pst).mul_(c)
        del pst
        s.fill_diagonal_(1.0)
    return s.fill_diagonal_(0.0)
