"""Distributed UniWalk SimRank, the ``giraph/SingleWalkVertex`` analog
(counterpart of ``graphtpu/dist/uniwalk_dist.py``).

Reference flow (``giraph/SingleWalkVertex.java:66-89``): every vertex emits
SAMPLE walker messages; each superstep walkers hop by vertex message, and
at even steps a similarity increment goes back to the source.  Sources
are sharded over the mesh's first axis (the Giraph worker partition);
walkers move between node owners through
:func:`graphtpu_torch.dist.frontier.exchange_by_owner`; each home rank
computes its own sources' first-meet increments and reduces them straight
to top-k, the flush.  :func:`graphtpu_torch.dist.windows.windowed_topk_sweep`
adds the batch windows and the durable cursor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import UniWalkConfig
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.dist.frontier import (
    _local_rows,
    distributed_uniform_walks,
    exchange_by_owner,
    narrowest_int_dtype,
)
from graphtpu_torch.dist.mesh import gather_rows, psum
from graphtpu_torch.dist.sharded_graph import ShardedGraph
from graphtpu_torch.kernels.topk import pair_topk_by_source, segment_sum_1d, segment_topk
from graphtpu_torch.simrank.uniwalk import _reuse_items, _tile_items


def _global_deg(g, device) -> torch.Tensor:
    """int32 [>= V] degree of any node id (replicated, O(V))."""
    return (g.deg_global if isinstance(g, ShardedGraph) else g.deg).to(device)


def distributed_uniwalk_simrank(
    g,
    mesh,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    max_walk_ints: int = 256 * 1024 * 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """(topk values, topk indices) for the given sources (default: all), on
    every rank.

    ``g``: a replicated :class:`Graph` or this rank's :class:`ShardedGraph`
    block.  Sources are padded to a multiple of the mesh size; each rank
    owns a contiguous source block and the walk frontier is exchanged by
    node ownership every hop.  The walk tensor is bounded at
    ``max_walk_ints`` int32s across the mesh: larger jobs loop over source
    windows, window ``lo`` on key ``key_for(key, lo)`` (the BATCH
    semantics, ``SingleWalkMasterCompute.java:29-35``)."""
    key = 0 if key is None else key
    axis = mesh.axis_names[0]
    n_dev = mesh.axis_size(axis)
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    n = len(sources)
    per_src_ints = cfg.sample * (2 * cfg.step + 1)
    if n * per_src_ints > max_walk_ints and n > n_dev:
        win = max(n_dev, (max_walk_ints // per_src_ints) // n_dev * n_dev)
        parts = [distributed_uniwalk_simrank(g, mesh, cfg, key=key_for(key, lo),
                                             sources=sources[lo: lo + win],
                                             max_walk_ints=max_walk_ints)
                 for lo in range(0, n, win)]
        return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))
    src_p = np.concatenate([sources, np.zeros((-n) % n_dev, np.int32)])
    n_p = len(src_p)
    walks = distributed_uniform_walks(
        g, n_walkers=n_p * cfg.sample, num_steps=2 * cfg.step, key=key, mesh=mesh,
        starts=np.repeat(src_p, cfg.sample))  # this rank's sources' walks
    w = walks.reshape(n_p // n_dev, cfg.sample, 2 * cfg.step + 1)
    # scatter-free: flat items -> sort-based per-source top-k; the diagonal
    # is excluded in _tile_items (target != source, SingleRandomWalk.java:44)
    targets, vals = _tile_items(_global_deg(g, mesh.device), w, cfg.step, cfg.c, cfg.sample)
    tv, ti = segment_topk(targets, vals, cfg.topk, g.n_nodes)
    group = mesh.groups[axis]
    return (gather_rows(tv, group).cpu().numpy()[:n], gather_rows(ti, group).cpu().numpy()[:n])


def distributed_uniwalk_simrank_reuse(
    g,
    mesh,
    cfg: UniWalkConfig = UniWalkConfig(),
    key: Optional[int] = None,
    walks=None,
    route_slack: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Distributed path-reuse UniWalk, the ``giraph/BatchSingleWalkVertexReuse``
    analog (TIMES offsets per physical walk,
    ``BatchSingleWalkVertexReuse.java:39-56``); (vals, idx) [V, topk] on
    every rank.

    Every node launches ``sample // reuse_times`` walkers of length
    ``2*step + reuse_times - 1``; offset ``o`` of each walk is a fresh sample
    whose source is ``path[o]``, any node, so (as Giraph routes sim
    increments to the source's owner) the increments cross ranks: each rank
    builds its flat (src, tgt, val) item stream, routes the items to their
    source's owner with one exchange, and reduces what it receives straight
    to top-k with the sort-based :func:`pair_topk_by_source`, normalised by
    the per-source sample counts summed over the mesh.  No [V, V] buffer
    anywhere.

    ``route_slack`` sizes the per-owner buckets at ``slack x fair share``
    beyond the self bucket; items past a bucket are dropped, and a run that
    drops any raises.  ``walks`` may inject the global reuse walks
    ([B, 2*step + times], B divisible by the mesh size)."""
    key = 0 if key is None else key
    axis = mesh.axis_names[0]
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group, dev = mesh.groups[axis], mesh.device
    v = g.n_nodes
    v_p = v + ((-v) % n_dev)
    times = max(cfg.reuse_times, 1)
    wpn = max(cfg.sample // times, 1)
    length = 2 * cfg.step + (times - 1)
    if walks is None:
        starts = np.repeat(np.arange(v, dtype=np.int32), wpn)
        # dead walkers pad the tail: never routed, their rows stay -1
        starts = np.concatenate([starts, np.full((-len(starts)) % n_dev, -1, np.int32)])
        n_walkers = len(starts)
        walks_l = distributed_uniform_walks(g, n_walkers=n_walkers, num_steps=length, key=key,
                                            mesh=mesh, starts=starts)
    else:
        n_walkers = walks.shape[0]
        if n_walkers % n_dev:
            raise ValueError(f"{n_walkers} walks do not split over {n_dev} ranks")
        walks_l = _local_rows(walks, me, n_walkers // n_dev, dev)

    rows_per = v_p // n_dev
    wd_node = narrowest_int_dtype(v_p - 1)
    items_local = (n_walkers // n_dev) * times * cfg.step
    # per (sender, owner) bucket: offset-0 sources are the walk starts, which
    # live on their own owner when starts are node-range aligned, so the self
    # bucket carries ~items/times; the other offsets mix toward uniform
    capacity = int(math.ceil(items_local / times)
                   + max(64, math.ceil(items_local / n_dev * route_slack)))

    srcs, tgts, vals, cnt_src = _reuse_items(_global_deg(g, dev), walks_l, cfg.step, cfg.c,
                                             times)
    counts = psum(segment_sum_1d(cnt_src, torch.ones_like(cnt_src, dtype=torch.float32), v_p),
                  group)
    owner = torch.where(srcs >= 0, srcs // rows_per, -1)
    per_owner = segment_sum_1d(owner, torch.ones_like(owner, dtype=torch.float32), n_dev)
    dropped = psum((per_owner - capacity).clamp(min=0).sum().reshape(1), group)
    # short-packed ids when V fits (Short_2MixMsgWritable.java); the values
    # stay f32 on the wire
    (r_src, r_tgt, r_val), _ = exchange_by_owner(
        (srcs, tgts, vals), owner, group, n_dev, capacity, wire_dtypes=(wd_node, wd_node, None))
    local_ids = me * rows_per + torch.arange(rows_per, dtype=torch.int32, device=dev)
    gv, gi = pair_topk_by_source(r_src.int(), r_tgt.int(), r_val, local_ids, cfg.topk,
                                 counts=counts)
    n_dropped = float(dropped[0])
    if n_dropped > 0:
        raise RuntimeError(f"reuse flush dropped {n_dropped:.0f} items; raise route_slack "
                           f"(capacity={capacity})")
    return (gather_rows(gv, group).cpu().numpy()[:v], gather_rows(gi, group).cpu().numpy()[:v])
