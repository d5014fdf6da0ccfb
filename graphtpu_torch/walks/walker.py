"""First-order random walks, batched (counterpart of ``graphtpu/walks/walker.py``).

A walk batch is an int32 [B] frontier advanced one hop at a time with one
CSR gather per hop, producing the whole [B, L+1] walk tensor on the device.
Dead ends hold -1 from the first dead step on (the reference breaks the
walk: ``node2vec.py:36-37``; ``Graph.java:69-73`` returns -1).  Hop t draws
from its own stream ``key_for(key, t)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.sampling import (
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)


def sorted_hop(step, cur: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """``step(cur, *rest)`` run on the frontier sorted by current node and
    put back in walker order, so the CSR reads of one hop are monotonic in
    memory.  Statistically the same walks; not the same bits."""
    order = torch.argsort(cur)
    out = torch.empty_like(cur)
    out[order] = step(cur[order], *(r[order] for r in rest))
    return out


def uniform_walks(
    g: Graph,
    starts: torch.Tensor,
    num_steps: int,
    key: int,
    weighted: bool = False,
    sort_gather: bool = False,
    device=None,
) -> torch.Tensor:
    """int32 [B, num_steps+1] walk tensor; column 0 is ``starts``.  Runs on
    ``device`` (default ``cuda``).  ``sort_gather``: see :func:`sorted_hop`."""
    dev = resolve_device(device)
    g = g.to(dev)
    cur = starts.to(device=dev, dtype=torch.int32)
    cumw = row_cumulative_weights(g) if weighted else None

    def sample(c, gen):
        if weighted:
            return weighted_neighbor(g, cumw, c, gen)
        return uniform_neighbor(g, c, gen)

    cols = [cur]
    for t in range(num_steps):
        gen = generator(key_for(key, t), dev)
        if sort_gather:
            cur = sorted_hop(lambda c: sample(c, gen), cur)
        else:
            cur = sample(cur, gen)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def walk_starts(g: Graph, num_walks: int, shuffle_key: Optional[int] = None) -> torch.Tensor:
    """Start nodes: ``num_walks`` passes over every non-isolated node, each
    pass shuffled from its own stream (``node2vec.py:41-59``), on the
    graph's device."""
    nodes = torch.nonzero(g.deg > 0)[:, 0].int()
    reps = []
    for i in range(num_walks):
        if shuffle_key is not None:
            gen = generator(key_for(shuffle_key, i), g.device)
            nodes_i = nodes[torch.randperm(nodes.numel(), generator=gen, device=g.device)]
        else:
            nodes_i = nodes
        reps.append(nodes_i)
    return torch.cat(reps)


def simulate_walks(
    g: Graph,
    num_walks: int,
    walk_length: int,
    key: int,
    p: float = 1.0,
    q: float = 1.0,
    weighted: bool = False,
    second_order_mode: str = "rejection",
    max_trials: int | None = None,
    sort_gather: bool = False,
    device=None,
) -> torch.Tensor:
    """The reference ``simulate_walks`` (node2vec.py:41-59): ``num_walks``
    shuffled passes over all nodes, ``walk_length`` *nodes* per walk.
    Returns int32 [num_walks*V', walk_length] on ``device`` (default
    ``cuda``)."""
    from graphtpu_torch.walks.node2vec import node2vec_walks

    dev = resolve_device(device)
    g = g.to(dev)
    starts = walk_starts(g, num_walks, key_for(key, 0))
    k_walk = key_for(key, 1)
    if p == 1.0 and q == 1.0:
        return uniform_walks(
            g, starts, walk_length - 1, k_walk, weighted=weighted,
            sort_gather=sort_gather, device=dev,
        )
    return node2vec_walks(
        g, starts, walk_length - 1, p=p, q=q, key=k_walk, weighted=weighted,
        mode=second_order_mode, max_trials=max_trials, sort_gather=sort_gather,
        device=dev,
    )


def walks_to_corpus(walks) -> list:
    """Host-side: walk tensor -> list of node-id lists (drop -1 padding),
    matching the walk lists fed to gensim (main.py:92-97)."""
    arr = walks.cpu().numpy() if isinstance(walks, torch.Tensor) else np.asarray(walks)
    out = []
    for row in arr:
        stop = np.argmax(row < 0) if (row < 0).any() else len(row)
        out.append([int(x) for x in row[:stop]])
    return out
