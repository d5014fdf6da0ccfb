"""BFS hop distances (counterpart of ``graphtpu/core/traversal.py``).

``utils/BFSDist.java:18-40`` computes BFS hop distances from the first
``maxStat`` sources.  Here the search is level-synchronous over the CSR:
the next frontier of node i is the OR of the current frontier over i's
neighbour segment, computed as a gather onto edge slots, an int32 prefix
sum and a difference at row boundaries (no dense [V, V] adjacency, no
scatter), so a chunk of S sources works in O(S * E) memory.  graphtpu's
prefix is float32 and stops being exact past 2^24 edge slots; the int32
prefix gives the same answers wherever graphtpu's are exact.  The loop's
stop test (an empty frontier) is one host sync per level.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph

_UNREACHED = np.iinfo(np.int32).max


def _bfs_chunk(row_ptr, col, src, max_dist: int) -> torch.Tensor:
    s, v = src.shape[0], row_ptr.shape[0] - 1
    lo, hi = row_ptr[:-1].long(), row_ptr[1:].long()
    col = col.long()
    front = torch.zeros((s, v), dtype=torch.bool, device=src.device)
    front[torch.arange(s, device=src.device), src.long()] = True
    dist = torch.where(front, 0, _UNREACHED).int()
    d = 0
    while d < max_dist and bool(front.any()):
        # reach[s, i] = OR of front[s, n] over the neighbours n of i
        csum = torch.nn.functional.pad(torch.cumsum(front[:, col], dim=1, dtype=torch.int32),
                                       (1, 0))
        nxt = ((csum[:, hi] - csum[:, lo]) > 0) & (dist == _UNREACHED)
        dist = torch.where(nxt, d + 1, dist)
        front = nxt
        d += 1
    return dist


def bfs_distances(
    g: Graph,
    sources: Optional[np.ndarray] = None,
    max_dist: int = 127,
    unreachable: int = -1,
    source_chunk: int = 32,
    device=None,
) -> np.ndarray:
    """int32 [S, V] hop distances from ``sources`` (default the first 100
    nodes), computed on ``device`` (default ``cuda``) in chunks of
    ``source_chunk`` sources; unreachable -> ``unreachable``."""
    dev = resolve_device(device)
    if sources is None:
        sources = np.arange(min(g.n_nodes, 100), dtype=np.int32)
    sources = np.asarray(sources, np.int32)
    rp, col, _, _ = g.host
    row_ptr = torch.from_numpy(rp).to(dev)
    col = torch.from_numpy(col).to(dev)
    out = np.empty((len(sources), g.n_nodes), np.int32)
    for lo in range(0, len(sources), max(source_chunk, 1)):
        src = torch.from_numpy(sources[lo: lo + source_chunk]).to(dev)
        out[lo: lo + len(src)] = _bfs_chunk(row_ptr, col, src, max_dist).cpu().numpy()
    out[out == _UNREACHED] = unreachable
    return out
