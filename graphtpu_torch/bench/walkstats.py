"""Random-walk statistical diagnostics (counterpart of
``graphtpu/bench/walkstats.py``).

The reference's random-walk assumption tests
(``simrank/random_test/RandomWalkTest.java:19-40``): exact against
Monte-Carlo path probabilities (``getPathPro``/``samplePathPro``
``:87-131``), the double-walk meeting probability
(``samplePathProDoubleWalk`` ``:142-167``) and the single-pair Monte-Carlo
SimRank probe (``testPairSimRank`` ``:175-210``).  Each probe runs its
whole sample batch as one [S, L] walk tensor on ``device`` (default
``cuda``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.walks.walker import uniform_walks


def _walks_from(g: Graph, node: int, samples: int, length: int, key: int, device):
    starts = torch.full((samples,), int(node), dtype=torch.int32, device=device)
    return uniform_walks(g, starts, length, key, device=device)


def random_path(g: Graph, src: int, length: int, key: Optional[int] = None,
                device=None) -> np.ndarray:
    """One uniform random path [length+1] from src (``randomPath :38-47``);
    dead ends leave -1 tails."""
    dev = resolve_device(device)
    return _walks_from(g, src, 1, length, 0 if key is None else key, dev)[0].cpu().numpy()


def path_probability(g: Graph, path: np.ndarray) -> float:
    """Exact forward probability of a path: prod 1/deg(path[i]) over all
    non-terminal positions (``getPathPro :87-93``)."""
    deg = g.host[3]
    d = deg[np.asarray(path[:-1], np.int64)]
    if (d == 0).any():
        return 0.0
    return float(np.prod(1.0 / d))


def sample_path_probability(g: Graph, path: np.ndarray, samples: int,
                            key: Optional[int] = None, device=None) -> float:
    """Monte-Carlo estimate of :func:`path_probability`: the share of
    ``samples`` walks from path[0] that follow the path
    (``samplePathPro :113-131``)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(path, np.int32), device=dev)
    walks = _walks_from(g, path[0], samples, len(path) - 1, 0 if key is None else key, dev)
    return float((walks == p[None, :]).all(dim=1).double().mean())


def double_meet_probability(g: Graph, path: np.ndarray) -> float:
    """Exact probability that two walkers from path[0] and path[-1] trace
    the path's two halves and meet at its midpoint (``testPathPro :76-80``)."""
    deg = g.host[3].astype(np.float64)
    n = len(path)
    # an even hop count (randPath's pathLen % 2 == 0): with an even node
    # count the halves would straddle the midpoint
    if n % 2 != 1:
        raise ValueError("path must have an even number of hops (odd node count)")
    p = 1.0
    for i in range((n - 1) // 2):
        d1, d2 = deg[path[i]], deg[path[n - 1 - i]]
        if d1 == 0 or d2 == 0:
            return 0.0
        p /= d1 * d2
    return float(p)


def sample_double_meet_probability(g: Graph, path: np.ndarray, samples: int,
                                   key: Optional[int] = None, device=None) -> float:
    """Monte-Carlo estimate of :func:`double_meet_probability`: two walker
    batches from both ends, counting joint traces that meet at the midpoint
    (``samplePathProDoubleWalk :142-167``)."""
    dev = resolve_device(device)
    n = len(path)
    if n % 2 != 1:
        raise ValueError("path must have an even number of hops (odd node count)")
    key = 0 if key is None else key
    mid = (n - 1) // 2
    p = torch.as_tensor(np.asarray(path, np.int32), device=dev)
    heads = _walks_from(g, path[0], samples, mid, key_for(key, 0), dev)
    tails = _walks_from(g, path[n - 1], samples, mid, key_for(key, 1), dev)
    ok_h = (heads == p[None, : mid + 1]).all(dim=1)
    ok_t = (tails == p.flip(0)[None, : mid + 1]).all(dim=1)
    return float((ok_h & ok_t).double().mean())


def _pair_estimate(g: Graph, src: int, dst: int, c: float, step: int, samples: int,
                   key: int, device) -> float:
    from graphtpu_torch.simrank.uniwalk import _first_meet_mask

    walks = _walks_from(g, src, samples, 2 * step, key, device)  # [S, 2*step+1]
    total = torch.zeros((), dtype=torch.float32, device=device)
    dst_deg = max(int(g.host[3][dst]), 1)
    for i in range(1, step + 1):
        ok = (walks[:, 2 * i] == dst) & _first_meet_mask(walks, i)
        inter_deg = g.deg[walks[:, i].clamp(min=0)].float()
        total += torch.where(ok, (c ** i) * inter_deg / dst_deg, 0.0).sum()
    return float(total / samples)


def pair_simrank_mc(
    g: Graph,
    src: int,
    dst: int,
    c: float = 0.6,
    step: int = 3,
    samples: int = 40000,
    times: int = 30,
    key: Optional[int] = None,
    device=None,
) -> Tuple[float, float]:
    """Single-pair UniWalk SimRank probe: mean and std over ``times``
    independent ``samples``-walk estimates (``testPairSimRank :175-210``;
    reference defaults times = 30, SAMPLE = 40000)."""
    if src == dst:
        raise ValueError("same nodes!")  # the reference prints and bails
    dev = resolve_device(device)
    g = g.to(dev)
    key = 0 if key is None else key
    ests = [_pair_estimate(g, src, dst, c, step, samples, key_for(key, t), dev)
            for t in range(times)]
    return float(np.mean(ests)), float(np.std(ests))
