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
prefix sum of their counts, and each slot finds its parent by a search of
those sums: on a CUDA tensor one launch of the hand kernel TS1
(``kernels/csrc/expand.cu``) a depth, counted in :data:`EXPAND_LAUNCHES`;
on the CPU the same in PyTorch ops (:func:`_expand_frontier_plain`), bit
for bit.  Children past W find no slot and their mass is dropped;
W defaults to 2*sample + 8, a bound on the children (sum(children) <=
sum(mass) + #sampled parents), so the default never drops mass.  The
dropped mass is reported (``stats``), where graphtpu computes and discards
it.  Tile ``lo`` draws depth ``d`` from stream ``key_for(key, lo, d)``.

Tiles run side by side in groups (:data:`GROUP_SLOTS`), each tile on its
own streams, so that its answer is the one it has alone.  A group runs in
three stages: ``expand`` (the 2*step expansions, keeping the frontiers of
the even depths), ``items`` (the first-meet masks and values over those
frontiers) and ``reduce`` (:func:`segment_topk` over the group's rows,
each row reduced alone); given
``stage_times``, each is timed by
:class:`~graphtpu_torch.utils.metrics.StageClock` under that name, and the
same kernels run as without it.  :func:`topsim_tile_frontiers` makes a
tile's frontiers at every depth from its key, as the tile loop does, and
:func:`topsim_frontiers_topk` is the estimator alone, on frontiers the
caller gives.  Every call adds to :data:`TOPSIM_COUNTS`, read as a
difference around a call, as ``uniwalk.UNIWALK_COUNTS`` is.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.sampling import neighbor_at
from graphtpu_torch.kernels.topk import segment_topk
from graphtpu_torch.simrank.uniwalk import _first_meet_mask, run_source_tiles

# graphtpu's cap on the enumerate frontier (d_max ** (2 * step) slots)
ENUMERATE_MAX_SLOTS = 1 << 17

# What topsim_simrank has spread: the sources of its groups of tiles (the
# last group's pad sources count, as they are spread), the frontier slots
# its expansions filled (W a source, 2*step depths) and the live ones among
# them, the slots holding a path with mass, counted on the device a group
# and read once a call.
TOPSIM_COUNTS = {"sources": 0, "slots": 0, "live": 0}

# TS1 launches (``_expand_frontier`` on a CUDA tensor), read as a difference
# around a call, as ``topk.TOPK_LAUNCHES`` is
EXPAND_LAUNCHES = {"expand": 0}

# Tiles spread side by side until a launch covers about this many frontier
# slots.  On an H100 80GB HBM3, a solve of GAP's Urand at scale 15 at SAMPLE
# 10,000 (640,256 slots a tile of 32 sources) took 7.6-10.2 s with one tile
# a launch, left to the host's dispatch (~700 launches a tile, the card ~35%
# busy); with 8, 16 or 32 tiles a launch 2.64, 2.51 or 2.41 s, set by the
# card, at a peak of 2.0, 3.9 or 7.8 GB.
GROUP_SLOTS = 10 << 20


def _draws(t: int, w: int, key: Union[int, Sequence[int]], dev) -> torch.Tensor:
    """[t * w] float32 uniforms: a sequence of keys gives each of as many
    equal blocks its own stream, drawn as the block alone would draw it."""
    keys = [key] if isinstance(key, int) else list(key)
    u = torch.empty(t * w, device=dev)
    block = u.numel() // len(keys)
    for i, k in enumerate(keys):
        u[i * block:(i + 1) * block].uniform_(generator=generator(k, dev))
    return u


def _expand_frontier(
    g: Graph,
    paths: torch.Tensor,  # [T, W, L]
    mass: torch.Tensor,   # [T, W]
    depth: int,
    key: Union[int, Sequence[int]],
    enumerate_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One budget-splitting step; returns new (paths', mass', dropped [T]).

    The sampled children draw from stream ``key``; a sequence of keys gives
    each of as many equal blocks of rows its own stream, drawn as the block
    alone would draw it.

    ``dropped`` is the mass of the children that found no slot: 0 unless
    the frontier overflows W.  (graphtpu's third value is the parents' mass
    less the children's, which also counts dead ends and rounding.)
    ``enumerate_all``: every active parent splits over every edge whatever
    its mass (``TopSim_Enumerate.java:101-129`` drops the budget guard).

    A CPU tensor runs :func:`_expand_frontier_plain`.  A CUDA tensor
    launches TS1 (``kernels/csrc/expand.cu``) on the current stream, or
    raises; there is no other path.  Both give the same paths and masses
    bit for bit; ``dropped`` sums in another order."""
    if paths.device.type == "cpu":
        return _expand_frontier_plain(g, paths, mass, depth, key, enumerate_all)
    if paths.device.type != "cuda":
        raise RuntimeError(f"no expansion kernel for device {paths.device}")
    check_expand_args(g, paths, mass, depth)
    # no child is sampled where every parent splits
    u = None if enumerate_all else _draws(paths.shape[0], paths.shape[1], key, paths.device)
    return ts1_expand(g, paths, mass, depth, u, enumerate_all)


def check_expand_args(g: Graph, paths: torch.Tensor, mass: torch.Tensor, depth: int) -> None:
    """Raise on what TS1 does not take: paths other than a contiguous
    [T, W, L] int32 tensor, mass other than a contiguous [T, W] float32
    one, a depth whose child node leaves the path, a graph whose ``col``
    and ``deg`` are not contiguous int32 or whose ``row_ptr`` is not
    contiguous int32 or int64, or tensors on more than one device.  Checks
    only: runs before any launch, on any device."""
    if paths.dim() != 3 or paths.dtype != torch.int32:
        raise TypeError(f"TS1 takes [T, W, L] int32 paths, got {paths.dtype} "
                        f"{tuple(paths.shape)}")
    if mass.dtype != torch.float32 or tuple(mass.shape) != tuple(paths.shape[:2]):
        raise TypeError(f"TS1 takes [T, W] float32 mass beside paths {tuple(paths.shape)}, "
                        f"got {mass.dtype} {tuple(mass.shape)}")
    _, w, length = paths.shape
    if not 0 <= depth < length - 1:
        raise ValueError(f"depth {depth}: the child node leaves paths of {length} nodes")
    if w < 1 or w * length >= 1 << 31:
        raise ValueError(f"TS1 takes 1 to 2^31 / L slots a row, got W = {w}, L = {length}")
    for name, x, dtypes in (("row_ptr", g.row_ptr, (torch.int32, torch.int64)),
                            ("col", g.col, (torch.int32,)), ("deg", g.deg, (torch.int32,))):
        if x.dtype not in dtypes:
            raise TypeError(f"TS1 takes the graph's {name} as {dtypes}, got {x.dtype}")
    for name, x in (("paths", paths), ("mass", mass), ("row_ptr", g.row_ptr),
                    ("col", g.col), ("deg", g.deg)):
        if not x.is_contiguous():
            raise ValueError(f"TS1 takes contiguous tensors; {name} is not")
        if x.device != paths.device:
            raise ValueError(f"TS1 takes its tensors on one device: {name} is on "
                             f"{x.device}, paths on {paths.device}")


def ts1_expand(g: Graph, paths, mass, depth: int, u: Optional[torch.Tensor],
               enumerate_all: bool = False):
    """One launch of TS1 on the current stream, the sampled children drawn
    at ``u`` ([T * W] float32 uniforms, a child's at its slot); the outputs
    are the one allocation."""
    from graphtpu_torch.kernels import _build

    check_expand_args(g, paths, mass, depth)
    t, w, length = paths.shape
    dev = paths.device
    if u is None and not enumerate_all:
        raise ValueError("TS1 draws its sampled children from u")
    if u is not None and (u.dtype != torch.float32 or u.numel() != t * w
                          or not u.is_contiguous() or u.device != dev):
        raise ValueError(f"TS1 takes u as {t * w} contiguous float32 on {dev}")
    new_paths = torch.empty_like(paths)
    child_mass = torch.empty_like(mass)
    dropped = torch.empty(t, dtype=torch.float32, device=dev)
    if t == 0:
        return new_paths, child_mass, dropped
    lib = _build.load()
    with torch.cuda.device(dev):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.gt_expand_frontier(
            paths.data_ptr(), mass.data_ptr(), None if u is None else u.data_ptr(),
            g.row_ptr.data_ptr(), g.row_ptr.element_size(), g.col.data_ptr(), g.n_edges,
            g.deg.data_ptr(), new_paths.data_ptr(), child_mass.data_ptr(), dropped.data_ptr(),
            t, w, length, depth, int(enumerate_all), cu_stream)
    if rc != 0:
        raise RuntimeError(f"expansion kernel launch failed: {_build.error_string(rc)}")
    EXPAND_LAUNCHES["expand"] += 1
    return new_paths, child_mass, dropped


def _expand_frontier_plain(
    g: Graph,
    paths: torch.Tensor,  # [T, W, L]
    mass: torch.Tensor,   # [T, W]
    depth: int,
    key: Union[int, Sequence[int]],
    enumerate_all: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`_expand_frontier`, in PyTorch ops on any
    device."""
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
    u = _draws(t, w, key, dev)
    samp_node = neighbor_at(g, p_cur.reshape(-1), u).reshape(t, w)
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


def _spread(g: Graph, src: torch.Tensor, keys: Sequence[int], cfg: TopSimConfig, cap: int):
    """The frontiers at depths 0..2*step of len(keys) tiles side by side
    (``src`` their sources, tile i drawing depth d+1 from
    ``key_for(keys[i], d)``), and the dropped mass of each source."""
    tile, dev = src.shape[0], src.device
    paths = torch.full((tile, cap, 2 * cfg.step + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0, 0] = src
    mass = torch.zeros((tile, cap), dtype=torch.float32, device=dev)
    mass[:, 0] = cfg.sample
    lost = torch.zeros(tile, dtype=torch.float32, device=dev)
    frontiers = [(paths, mass)]
    for depth in range(2 * cfg.step):
        paths, mass, dropped = _expand_frontier(g, paths, mass, depth,
                                                [key_for(k, depth) for k in keys],
                                                enumerate_all=cfg.enumerate_all)
        lost += dropped
        frontiers.append((paths, mass))
    return frontiers, lost


def topsim_tile_frontiers(g: Graph, src_tile: torch.Tensor, key: int, cfg: TopSimConfig,
                          cap: Optional[int] = None):
    """One source tile's frontiers as :func:`topsim_simrank`'s tiles make
    them: ([(paths [T, W, 2*step+1] int32, mass [T, W] float32) at depths
    0, 1, ..., 2*step], dropped mass [T]).  ``key`` is the tile's
    (``key_for(key, lo)`` of the call's), depth d+1 drawn from
    ``key_for(key, d)``; W is ``cap`` (default :func:`frontier_capacity`).
    A slot holds a path while its mass is above 0; empty slots read -1."""
    return _spread(g, src_tile, [key], cfg, cap or frontier_capacity(g, cfg))


def _frontier_items(g: Graph, frontiers, cfg: TopSimConfig):
    """([T, W*step] targets, values) of the frontiers at depths 2, 4, ...,
    2*step; invalid items carry target -1."""
    if len(frontiers) != cfg.step or frontiers[0][0].shape[-1] != 2 * cfg.step + 1:
        raise ValueError(f"step {cfg.step} wants {cfg.step} frontiers of paths of "
                         f"{2 * cfg.step + 1} nodes")
    tgt_list, val_list = [], []
    for i, (paths, mass) in enumerate(frontiers, start=1):
        inter, target = paths[:, :, i], paths[:, :, 2 * i]
        ok = ((mass > 0) & (target >= 0) & (target != paths[:, :, 0])
              & _first_meet_mask(paths[:, :, : 2 * i + 1], i))
        val = (mass * (cfg.c ** i) * g.deg[inter.clamp(min=0)].float()
               / g.deg[target.clamp(min=0)].clamp(min=1).float())
        if cfg.normalize:
            val = val / cfg.sample
        tgt_list.append(torch.where(ok, target, -1))
        val_list.append(torch.where(ok, val, 0.0))
    return torch.cat(tgt_list, dim=1), torch.cat(val_list, dim=1)


def topsim_frontiers_topk(g: Graph, frontiers, cfg: TopSimConfig):
    """(vals [T, topk], int32 idx [T, topk]) of the estimator on given
    frontiers, those of depths 2, 4, ..., 2*step (``topsim_tile_frontiers(
    ...)[0][2::2]``), on their device: the items and the reduce of
    :func:`topsim_simrank`'s tiles, C, SAMPLE, step and top-k from ``cfg``."""
    return segment_topk(*_frontier_items(g, frontiers, cfg), cfg.topk, g.n_nodes)


def topsim_tile_items(g: Graph, src_tile: torch.Tensor, key: int, cfg: TopSimConfig,
                      cap: int):
    """([T, cap*step] targets, values, dropped mass [T]) of one source tile."""
    frontiers, lost = topsim_tile_frontiers(g, src_tile, key, cfg, cap)
    return (*_frontier_items(g, frontiers[2::2], cfg), lost)


def topsim_simrank(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    dense: bool = False,
    device=None,
    stats: Optional[dict] = None,
    stage_times: Optional[dict] = None,
):
    """TopSim_singleSample (or, with ``cfg.enumerate_all``, TopSim_Enumerate)
    for all (or the given) sources, on ``device`` (default ``cuda``).

    Returns (topk_values, topk_indices) numpy arrays or the dense [N, V]
    matrix.  ``stats``, when given, receives ``dropped_mass``: the mass the
    frontier could not hold, summed over sources and depths.
    ``stage_times``, when given, receives the ms of the stages ``expand``,
    ``items`` and ``reduce``.  The call adds to :data:`TOPSIM_COUNTS`."""
    dev = resolve_device(device)
    g = g.to(dev)
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    cap = frontier_capacity(g, cfg)
    tile = min(cfg.source_tile, len(sources))
    tiles = -(-len(sources) // tile)
    groups = -(-tiles // max(1, GROUP_SLOTS // (tile * cap)))
    group = -(-tiles // groups)  # tiles a launch, spread evenly over the groups
    lost = []
    live = torch.zeros((), dtype=torch.int64, device=dev)

    def expand(src, keys):
        frontiers, dropped = _spread(g, src, keys, cfg, cap)
        lost.append(dropped)
        for _, m in frontiers[1:]:
            live.add_(m.count_nonzero())
        return frontiers[2::2]

    out = run_source_tiles([("expand", expand), ("items", lambda f: _frontier_items(g, f, cfg))],
                           g.n_nodes, sources, tile, cfg.topk, 0 if key is None else key,
                           dense, dev, stage_times, group=group)
    TOPSIM_COUNTS["sources"] += groups * group * tile
    TOPSIM_COUNTS["slots"] += groups * group * tile * cap * 2 * cfg.step
    TOPSIM_COUNTS["live"] += int(live)
    if stats is not None:  # the padded last tile's pad sources are not counted
        stats["dropped_mass"] = float(torch.cat(lost)[: len(sources)].double().sum())
    return out
