"""UniWalk: single-walk Monte-Carlo SimRank, batched (counterpart of
``graphtpu/simrank/uniwalk.py``).

Reference estimator (``simrank/SingleRandomWalk.java:53-106``): per source
v, SAMPLE uniform walks of length 2*STEP; for step i, if the prefix 0..2i
is *first-meet* (path[j] != path[2i-j] for all j < i), add

    C^i * deg(path[i]) / deg(path[2i]) / SAMPLE     to  sim[v][path[2i]].

Sources go in tiles (the batched-source windows of
``giraph/BatchSingleWalkVertex.java:108-133``): a tile's [T, SAMPLE,
2*STEP+1] walks come from one batched walk call, the first-meet test is a
mask over step prefixes, and the increments reduce to each source's top-k
by :func:`segment_topk` (a sort, no scatter, no [T, V] tile).  Tile ``lo``
walks on stream ``key_for(key, lo)``.  A tile runs in three stages,
``walks``, ``items`` (the first-meet masks and values) and ``reduce``
(:func:`segment_topk`); given ``stage_times``, each is timed by
:class:`~graphtpu_torch.utils.metrics.StageClock` under that name, and the
same kernels run as without it.  :func:`uniwalk_walks_topk` is the
estimator alone, on walks the caller gives.

Every call adds to :data:`UNIWALK_COUNTS`, read as a difference around a
call, as ``kernels.spmm.SPMV_LAUNCHES`` is.

Path reuse (``SingleRandomWalkOptimal2.java:49-64``): one physical walk of
length (times-1) + 2*STEP feeds every offset o as a fresh sample for source
path[o]; each source's estimate is normalised by the samples it received
(``CombineBatchSingleWalkVertexReuse.java:79-94``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import UniWalkConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.kernels.topk import (
    pair_topk_by_source,
    segment_sum_1d,
    segment_topk,
)
from graphtpu_torch.utils.metrics import StageClock
from graphtpu_torch.walks.walker import uniform_walks

# What uniwalk_simrank has walked: the walkers of the walks its tiles made
# (the last tile's pad sources count, as they are walked) and the hops of
# the walks that reached their last node, 2*step each, counted on the device
# a tile and read once a call.  A walk stops only at a node with no
# neighbour, which on an undirected graph is its source alone, so there the
# hops are every hop taken.
UNIWALK_COUNTS = {"walkers": 0, "hops": 0}


def _first_meet_mask(walks: torch.Tensor, i: int) -> torch.Tensor:
    """first-meet for prefix 0..2i: all j < i have path[j] != path[2i-j].
    walks: [..., L]; returns bool [...]."""
    ok = torch.ones(walks.shape[:-1], dtype=torch.bool, device=walks.device)
    for j in range(i):
        ok &= walks[..., j] != walks[..., 2 * i - j]
    return ok


def _meet_value(deg: torch.Tensor, inter: torch.Tensor, target: torch.Tensor,
                c: float, i: int) -> torch.Tensor:
    """C^i * deg(inter) / max(deg(target), 1), in graphtpu's float32 order."""
    return ((c ** i) * deg[inter.clamp(min=0)].float()
            / deg[target.clamp(min=0)].clamp(min=1).float())


def _tile_items(deg: torch.Tensor, walks: torch.Tensor, step: int, c: float, sample: int):
    """(targets [T, S*step], values [T, S*step]) increment items from
    [T, S, 2*step+1] walks, step-major; invalid items carry target -1."""
    source = walks[:, :, 0]
    tgt_list, val_list = [], []
    for i in range(1, step + 1):
        target = walks[:, :, 2 * i]
        ok = (target >= 0) & (target != source) & _first_meet_mask(walks, i)
        val = _meet_value(deg, walks[:, :, i], target, c, i) / sample
        tgt_list.append(torch.where(ok, target, -1))
        val_list.append(torch.where(ok, val, 0.0))
    return torch.cat(tgt_list, dim=1), torch.cat(val_list, dim=1)


def _dense_tile(targets: torch.Tensor, vals: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[T, V] per-target sums of [T, N] items (target < 0 = skip): a
    scatter with float adds, so its bits may vary on a CUDA device."""
    t = targets.shape[0]
    sim = torch.zeros((t, n_nodes), dtype=torch.float32, device=targets.device)
    rows = torch.arange(t, device=targets.device)[:, None].expand_as(targets)
    sim.index_put_((rows, targets.clamp(min=0).long()),
                   torch.where(targets >= 0, vals, 0.0), accumulate=True)
    return sim


def _tile_increments(deg: torch.Tensor, n_nodes: int, walks: torch.Tensor, step: int,
                     c: float, sample: int) -> torch.Tensor:
    """[T, V] similarity tile from [T, S, 2*step+1] walks (dense form)."""
    return _dense_tile(*_tile_items(deg, walks, step, c, sample), n_nodes)


def _tile_walks(g: Graph, src_tile: torch.Tensor, key: int, sample: int, step: int):
    starts = torch.repeat_interleave(src_tile, sample)
    walks = uniform_walks(g, starts, 2 * step, key, device=g.device)
    return walks.reshape(src_tile.shape[0], sample, 2 * step + 1)


def _walk_items(g: Graph, walks: torch.Tensor, cfg: UniWalkConfig):
    """The items of [T, SAMPLE, 2*step+1] walks, SAMPLE their second dim."""
    if walks.shape[-1] != 2 * cfg.step + 1:
        raise ValueError(f"walks of {walks.shape[-1]} nodes; step {cfg.step} needs "
                         f"{2 * cfg.step + 1}")
    return _tile_items(g.deg, walks, cfg.step, cfg.c, walks.shape[1])


def uniwalk_walks_topk(g: Graph, walks: torch.Tensor, cfg: UniWalkConfig):
    """(vals [T, topk], int32 idx [T, topk]) of the estimator on given walks
    [T, SAMPLE, 2*step+1] (column 0 each source, -1 past a dead end), on the
    walks' device: the items and the reduce of :func:`uniwalk_simrank`'s
    tiles, SAMPLE read from ``walks`` and C, step and top-k from ``cfg``."""
    return segment_topk(*_walk_items(g, walks, cfg), cfg.topk, g.n_nodes)


def uniwalk_tile_topk(g: Graph, src_tile: torch.Tensor, key: int, cfg: UniWalkConfig):
    """(vals [T, topk], idx [T, topk]) of one source tile on the graph's
    device; the diagonal is excluded by the items (target != source)."""
    return uniwalk_walks_topk(g, _tile_walks(g, src_tile, key, cfg.sample, cfg.step), cfg)


def run_source_tiles(stages, n_nodes: int, sources: np.ndarray, tile: int, topk: int,
                     key: int, dense: bool, dev, stage_times: Optional[dict] = None,
                     group: int = 1):
    """Each tile's item stream reduced to its sources' top-k (:func:`segment_topk`)
    or, when ``dense``, scattered into [T, V] rows with each source's own
    column zeroed (``SingleRandomWalk.java:44``).  Tiles run ``group`` at a
    time, side by side: ``stages`` are their named steps, the first called
    as ``fn(src, keys)`` on the group's [group*tile] sources and each tile's
    stream ``key_for(key, lo)``, each later one on the output of the one
    before, the last giving (targets, values) a source; the group's rows are
    then reduced in one call, in which each row is reduced alone (a stable
    sort, float64 prefix sums and the top-k along the row), so a tile's
    answer is the same in any group.  The
    sources are padded with source 0 to whole groups, as graphtpu pads the
    last tile.  ``stage_times``: the ms of each stage and, in the top-k form,
    of ``reduce`` (:class:`StageClock`).
    Returns host (vals, idx) or the dense [N, V] rows."""
    clock = StageClock(stage_times, dev)
    n = len(sources)
    span = tile * group
    out_vals = torch.zeros((n, topk), dtype=torch.float32, device=dev)
    out_idx = torch.zeros((n, topk), dtype=torch.int32, device=dev)
    out_dense = np.zeros((n, n_nodes), np.float32) if dense else None
    padded = np.zeros(-(-n // span) * span, np.int32)
    padded[:n] = sources
    # one upload for all tiles: a copy from pageable host memory waits for the
    # device, and one a tile idles the card while the host queues the tile's
    # first launches, so that the solve runs at the host's speed
    all_src = torch.from_numpy(padded).to(dev)
    (first_name, first), *rest = stages
    for lo in range(0, n, span):
        src = all_src[lo:lo + span]
        out = clock.stage(first_name, first, src,
                          [key_for(key, lo + s) for s in range(0, span, tile)])
        for name, fn in rest:
            out = clock.stage(name, fn, out)
        targets, vals = out
        m = min(span, n - lo)
        if dense:
            sim = _dense_tile(targets, vals, n_nodes)
            sim[torch.arange(span, device=dev), src.long()] = 0.0
            out_dense[lo:lo + m] = sim[:m].cpu().numpy()
            continue
        vk, ik = clock.stage("reduce", segment_topk, targets, vals, topk, n_nodes)
        out_vals[lo:lo + m] = vk[:m]
        out_idx[lo:lo + m] = ik[:m]
    clock.close()
    if dense:
        return out_dense
    return out_vals.cpu().numpy(), out_idx.cpu().numpy()


def uniwalk_simrank(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    dense: bool = False,
    device=None,
    stage_times: Optional[dict] = None,
):
    """UniWalk SimRank for all (or the given) sources, on ``device``
    (default ``cuda``).

    Returns ``(topk_values [N, topk], topk_indices [N, topk])`` numpy arrays
    in source order, or the dense [N, V] matrix when ``dense``.
    ``stage_times``, when given, receives the ms of the stages ``walks``,
    ``items`` and ``reduce``.  The call adds its walkers and hops to
    :data:`UNIWALK_COUNTS`."""
    dev = resolve_device(device)
    g = g.to(dev)
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    ended = torch.zeros((), dtype=torch.int64, device=dev)

    def walks(src, keys):
        w = _tile_walks(g, src, keys[0], cfg.sample, cfg.step)
        UNIWALK_COUNTS["walkers"] += w.shape[0] * w.shape[1]
        # the last node alone: a count over every node took 0.24 ms a tile on
        # an H100, 2.4% of a solve
        ended.add_((w[..., -1] >= 0).sum())
        return w

    out = run_source_tiles([("walks", walks), ("items", lambda w: _walk_items(g, w, cfg))],
                           g.n_nodes, sources, min(cfg.source_tile, len(sources)), cfg.topk,
                           0 if key is None else key, dense, dev, stage_times)
    UNIWALK_COUNTS["hops"] += int(ended) * 2 * cfg.step
    return out


def _reuse_items(deg: torch.Tensor, walks: torch.Tensor, step: int, c: float, times: int):
    """Flat (srcs, tgts, vals, sample_srcs) item stream from reuse walks.

    ``walks``: [B, 2*step + times]; offset ``o`` of each physical walk is a
    fresh sample whose source is ``path[o]``
    (``SingleRandomWalkOptimal2.java:49-64``).  ``srcs``/``tgts`` carry -1
    for filtered items; ``sample_srcs`` lists one entry per (walk, offset)
    live sample (-1 when dead) for the flush normalisation counts.
    """
    src_list, tgt_list, val_list, cnt_list = [], [], [], []
    for o in range(times):
        seg = walks[:, o : o + 2 * step + 1]
        src = seg[:, 0]
        live = src >= 0
        cnt_list.append(torch.where(live, src, -1))
        for i in range(1, step + 1):
            target = seg[:, 2 * i]
            ok = live & (target >= 0) & (target != src) & _first_meet_mask(seg, i)
            val = _meet_value(deg, seg[:, i], target, c, i)
            src_list.append(torch.where(ok, src, -1))
            tgt_list.append(torch.where(ok, target, -1))
            val_list.append(torch.where(ok, val, 0.0))
    return (torch.cat(src_list), torch.cat(tgt_list), torch.cat(val_list),
            torch.cat(cnt_list))


def _reuse_walks(g: Graph, cfg: UniWalkConfig, key: Optional[int], walks, dev):
    if isinstance(walks, torch.Tensor):
        return walks.to(dev)
    if walks is not None:
        return torch.from_numpy(np.array(walks)).to(dev)
    times = max(cfg.reuse_times, 1)
    starts = torch.repeat_interleave(torch.arange(g.n_nodes, dtype=torch.int32, device=dev),
                                     max(cfg.sample // times, 1))
    return uniform_walks(g, starts, 2 * cfg.step + times - 1, 0 if key is None else key,
                         device=dev)


def _reuse_stream(g: Graph, cfg: UniWalkConfig, walks: torch.Tensor):
    """The reuse items and each source's received-sample counts."""
    srcs, tgts, vals, cnt_src = _reuse_items(g.deg, walks, cfg.step, cfg.c,
                                             max(cfg.reuse_times, 1))
    counts = segment_sum_1d(cnt_src, torch.ones_like(cnt_src, dtype=torch.float32),
                            g.n_nodes)
    return srcs, tgts, vals, counts


def uniwalk_simrank_reuse(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[int] = None,
    walks=None,
    device=None,
) -> np.ndarray:
    """Path-reuse UniWalk, dense [V, V] (the small-graph oracle; a scatter
    with float adds, so its bits may vary on a CUDA device).

    ``cfg.reuse_times`` offsets per physical walk; each node launches
    ``sample // reuse_times`` walkers; each source's estimate is normalised
    by the samples it received.  ``walks`` may inject reuse walks
    ([B, 2*step + times])."""
    dev = resolve_device(device)
    g = g.to(dev)
    v = g.n_nodes
    srcs, tgts, vals, counts = _reuse_stream(g, cfg, _reuse_walks(g, cfg, key, walks, dev))
    sim = torch.zeros((v, v), dtype=torch.float32, device=dev)
    sim.index_put_((srcs.clamp(min=0).long(), tgts.clamp(min=0).long()),
                   torch.where(srcs >= 0, vals, 0.0), accumulate=True)
    sim = sim / counts.clamp(min=1.0)[:, None]
    return sim.fill_diagonal_(0.0).cpu().numpy()


def uniwalk_simrank_reuse_topk(
    g: Graph,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[int] = None,
    walks=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter-free path-reuse UniWalk: (vals [V, topk], idx [V, topk]).

    The estimator of :func:`uniwalk_simrank_reuse`, accumulated by one
    sort-based :func:`pair_topk_by_source` over the flat item stream: no
    [V, V] buffer, no scatter, the same bits on every run."""
    dev = resolve_device(device)
    g = g.to(dev)
    srcs, tgts, vals, counts = _reuse_stream(g, cfg, _reuse_walks(g, cfg, key, walks, dev))
    out_v, out_i = pair_topk_by_source(
        srcs, tgts, vals, torch.arange(g.n_nodes, device=dev), cfg.topk, counts=counts)
    return out_v.cpu().numpy(), out_i.cpu().numpy()
