"""TopSim: deterministic-spreading single-walk SimRank (counterpart of
``graphtpu/simrank/topsim.py``).

Reference (``simrank/TopSim_singleSample.java:62-203``): per source, a
queue of budget-carrying paths.  A frontier path at node ``cur`` with
budget ``s``:

  * ``s >= degree``: splits evenly, every neighbour gets a child with
    budget s/degree (``:99-124``);
  * else: draws ``ceil(s)`` random neighbours, each child carrying
    s/ceil(s) (``:126-149``).

At every even depth 2i the frontier adds ``budget * C^i * deg(path[i]) /
deg(path[2i])`` to ``sim[src][path[2i]]`` under UniWalk's first-meet test
(``:167-218``).

The queue is a fixed-capacity slot tensor per source tile: paths [T, W,
L+1] with a budget per slot [T, W].  Children get slots by an exclusive
prefix sum of their counts, and each slot finds its parent by one batched
``searchsorted``.  Children past W find no slot and their mass is dropped;
W defaults to 2*sample + 8, a bound on the children (sum(children) <=
sum(mass) + #sampled parents), so the default never drops mass.  The
dropped mass is reported (``stats``), where graphtpu computes and discards
it.  Tile ``lo`` draws depth ``d`` from stream ``key_for(key, lo, d)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.sampling import uniform_neighbor
from graphtpu_torch.simrank.uniwalk import _first_meet_mask, run_source_tiles

# graphtpu's cap on the enumerate frontier (d_max ** (2 * step) slots)
ENUMERATE_MAX_SLOTS = 1 << 17


def _expand_frontier(
    g: Graph,
    paths: torch.Tensor,  # [T, W, L]
    mass: torch.Tensor,   # [T, W]
    depth: int,
    key: int,
    enumerate_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One budget-splitting step; returns (paths', mass', dropped [T]).

    ``dropped`` is the mass of the children that found no slot: 0 unless
    the frontier overflows W.  (graphtpu's third value is the parents' mass
    less the children's, which also counts dead ends and rounding.)
    ``enumerate_all``: every active parent splits over every edge whatever
    its mass (``TopSim_Enumerate.java:101-129`` drops the budget guard)."""
    t, w, length = paths.shape
    dev = paths.device
    cur = paths[:, :, depth]
    d = g.deg[cur.clamp(min=0)]
    active = (mass > 0) & (cur >= 0) & (d > 0)
    split = active if enumerate_all else active & (mass >= d)
    nchild = torch.where(split, d, torch.ceil(mass).int())
    nchild = torch.where(active, nchild, 0).long()
    ends = torch.cumsum(nchild, dim=1)
    offs = ends - nchild  # exclusive prefix sum
    total = ends[:, -1]
    lost = (ends - w).clamp(min=0).minimum(nchild)
    dropped = (mass * lost / nchild.clamp(min=1)).sum(dim=1)

    # the parent of each output slot: the last parent whose offs <= slot
    slots = torch.arange(w, device=dev).expand(t, w).contiguous()
    parent = (torch.searchsorted(offs, slots, right=True) - 1).clamp(0, w - 1)
    rank = slots - offs.gather(1, parent)
    p_nchild = nchild.gather(1, parent)
    valid = (slots < total[:, None]) & (rank < p_nchild) & (rank >= 0)
    p_cur = cur.gather(1, parent)
    p_mass = mass.gather(1, parent)
    p_split = split.gather(1, parent)

    # even-split children: neighbour `rank` of the parent's CSR row
    base = g.row_ptr[p_cur.clamp(min=0)].long()
    split_node = g.col[(base + rank).clamp(0, max(g.n_edges - 1, 0))]
    # sampled children: independent uniform neighbour draws
    samp_node = uniform_neighbor(g, p_cur.reshape(-1), generator(key, dev)).reshape(t, w)
    node = torch.where(p_split, split_node, samp_node)
    node = torch.where(valid, node, -1)
    child_mass = torch.where(valid, p_mass / p_nchild.clamp(min=1), 0.0)

    new_paths = paths.gather(1, parent[:, :, None].expand(t, w, length))
    new_paths[:, :, depth + 1] = node
    new_paths = torch.where(valid[:, :, None], new_paths, -1)
    return new_paths, child_mass, dropped


def frontier_capacity(g: Graph, cfg: TopSimConfig) -> int:
    """Walker slots per source: ``cfg.frontier_capacity``, else 2*sample + 8,
    or for full enumeration d_max ** (2*step), which raises past 2^17."""
    if cfg.frontier_capacity:
        return cfg.frontier_capacity
    if cfg.enumerate_all:
        cap = max(g.max_degree, 1) ** (2 * cfg.step)
        if cap > ENUMERATE_MAX_SLOTS:
            raise ValueError(
                f"enumerate_all frontier bound {cap} too large; set "
                "frontier_capacity explicitly (dropped mass is accepted)"
            )
        return cap
    return 2 * math.ceil(cfg.sample) + 8


def topsim_tile_items(g: Graph, src_tile: torch.Tensor, key: int, cfg: TopSimConfig,
                      cap: int):
    """([T, cap*step] targets, values, dropped mass [T]) of one source tile."""
    tile, dev = src_tile.shape[0], src_tile.device
    length = 2 * cfg.step + 1
    paths = torch.full((tile, cap, length), -1, dtype=torch.int32, device=dev)
    paths[:, 0, 0] = src_tile
    mass = torch.zeros((tile, cap), dtype=torch.float32, device=dev)
    mass[:, 0] = cfg.sample
    lost = torch.zeros(tile, dtype=torch.float32, device=dev)
    tgt_list, val_list = [], []
    for depth in range(2 * cfg.step):
        paths, mass, dropped = _expand_frontier(g, paths, mass, depth, key_for(key, depth),
                                                enumerate_all=cfg.enumerate_all)
        lost += dropped
        lvl = depth + 1
        if lvl % 2:
            continue
        i = lvl // 2
        inter, target = paths[:, :, i], paths[:, :, 2 * i]
        ok = ((mass > 0) & (target >= 0) & (target != src_tile[:, None])
              & _first_meet_mask(paths[:, :, : 2 * i + 1], i))
        val = (mass * (cfg.c ** i) * g.deg[inter.clamp(min=0)].float()
               / g.deg[target.clamp(min=0)].clamp(min=1).float())
        if cfg.normalize:
            val = val / cfg.sample
        tgt_list.append(torch.where(ok, target, -1))
        val_list.append(torch.where(ok, val, 0.0))
    return torch.cat(tgt_list, dim=1), torch.cat(val_list, dim=1), lost


def topsim_simrank(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    dense: bool = False,
    device=None,
    stats: Optional[dict] = None,
):
    """TopSim_singleSample (or, with ``cfg.enumerate_all``, TopSim_Enumerate)
    for all (or the given) sources, on ``device`` (default ``cuda``).

    Returns (topk_values, topk_indices) numpy arrays or the dense [N, V]
    matrix.  ``stats``, when given, receives ``dropped_mass``: the mass the
    frontier could not hold, summed over sources and depths."""
    dev = resolve_device(device)
    g = g.to(dev)
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    cap = frontier_capacity(g, cfg)
    lost = []

    def items(src, k):
        targets, vals, dropped = topsim_tile_items(g, src, k, cfg, cap)
        lost.append(dropped)
        return targets, vals

    out = run_source_tiles([("items", items)], g.n_nodes, sources,
                           min(cfg.source_tile, len(sources)), cfg.topk,
                           0 if key is None else key, dense, dev)
    if stats is not None:  # the padded last tile's pad sources are not counted
        stats["dropped_mass"] = float(torch.cat(lost)[: len(sources)].double().sum())
    return out
