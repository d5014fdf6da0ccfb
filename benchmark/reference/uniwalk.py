"""Plain single-walk Monte-Carlo SimRank in float64: the benchmark's
reference for UniWalk's estimator (the reference's
``SingleRandomWalk.java:53-106``), over walks it is given.

For walks [T, SAMPLE, 2·STEP+1] (column 0 each row's source, -1 from a dead
end on) and each step i = 1..STEP, a walk whose node 2i is alive and whose
prefix 0..2i is first-meet (path[j] != path[2i-j] for every j < i, tested
one j at a time) adds

    C^i · deg(path[i]) / deg(path[2i]) / SAMPLE

to its row's column path[2i], into a dense [T, V] float64 tile by
``index_add_``.  Each source's own column is then zeroed.  The estimand is
exact SimRank after STEP iterations (``simrank.py``).  Plain PyTorch, with
no sort and TF32 off; it imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def degrees(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """Distinct neighbours of each node of the undirected graph (each pair
    mirrored, duplicates collapsed), as ``simrank.transition`` counts them."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    key = np.unique(np.concatenate([e[:, 0] * n_nodes + e[:, 1], e[:, 1] * n_nodes + e[:, 0]]))
    return np.bincount(key // n_nodes, minlength=n_nodes)


def scores(walks: torch.Tensor, deg: np.ndarray, n_nodes: int, c: float) -> torch.Tensor:
    """Dense float64 [T, V] estimates from ``walks`` [T, SAMPLE, 2·STEP+1],
    on the walks' device, each row's source column zeroed."""
    w = walks.long()
    t, sample, length = w.shape
    dev = w.device
    d = torch.as_tensor(np.asarray(deg), dtype=torch.float64, device=dev)
    sim = torch.zeros((t, n_nodes), dtype=torch.float64, device=dev)
    row = torch.arange(t, device=dev)[:, None].expand(t, sample)
    with _no_tf32():
        for i in range(1, (length - 1) // 2 + 1):
            target = w[:, :, 2 * i]
            meet = target >= 0
            for j in range(i):
                meet &= w[:, :, j] != w[:, :, 2 * i - j]
            val = (c ** i) * d[w[:, :, i].clamp(min=0)] / d[target.clamp(min=0)] / sample
            sim.view(-1).index_add_(0, (row * n_nodes + target)[meet], val[meet])
    sim[torch.arange(t, device=dev), w[:, 0, 0]] = 0.0
    return sim


def topk(sim: torch.Tensor, k: int):
    """(values, ids) of each row's k largest estimates."""
    return torch.topk(sim, k, dim=1)
