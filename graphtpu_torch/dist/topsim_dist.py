"""Distributed TopSim, the flagship Giraph run's role (counterpart of
``graphtpu/dist/topsim_dist.py``).

``giraph/CombineBatchSingleWalkVertexReuse`` distributes budget-splitting
walks over 14 workers with combined walker-count messages
(``mySendMsg :139-161``): a message carries a walker count; at each hop
it splits ``count/degree`` over every edge plus remainder singles to
random neighbours, and sim increments route back to the source's owner.
The single-device kernel (:mod:`graphtpu_torch.simrank.topsim`) is that
mass-splitting semantics; this module distributes it two ways:

* a replicated ``Graph``: each rank expands its own block of every source
  window, no collective but the gather of the results (the reference's
  source batching);
* a partitioned :class:`ShardedGraph`: frontier items (path, mass) live at
  their current node's OWNER, expand against only the local CSR block, and
  the children route to their own owners with one exchange a depth; sim
  increments route to the source's owner at the flush (the ``mySendMsg``
  message cycle; no rank holds the whole adjacency).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.prng import generator, key_for, per_device_key
from graphtpu_torch.dist.frontier import exchange_by_owner, narrowest_int_dtype
from graphtpu_torch.dist.mesh import gather_rows, psum
from graphtpu_torch.dist.sharded_graph import ShardedGraph, local_graph
from graphtpu_torch.kernels.sampling import uniform_neighbor
from graphtpu_torch.kernels.topk import pair_topk_by_source, segment_sum_1d, segment_topk
from graphtpu_torch.simrank.topsim import frontier_capacity, topsim_tile_items
from graphtpu_torch.simrank.uniwalk import _first_meet_mask


def _source_windows(sources: np.ndarray, window: int):
    """(lo, m, chunk): each window of ``window`` sources, the last padded
    with source 0."""
    n = len(sources)
    for lo in range(0, n, window):
        m = min(window, n - lo)
        chunk = np.zeros(window, np.int32)
        chunk[:m] = sources[lo: lo + m]
        yield lo, m, chunk


def distributed_topsim_simrank(
    g,
    mesh,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    device_capacity: Optional[int] = None,
    route_slack: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(values [N, topk], indices [N, topk]) for the given sources (default:
    all), on every rank.  ``g`` is a replicated :class:`Graph` (sources
    sharded) or this rank's :class:`ShardedGraph` block (an owner exchange a
    depth).  Window ``lo`` of rank d draws depth ``t`` from
    ``key_for(key, lo, d, t)``."""
    key = 0 if key is None else key
    if isinstance(g, ShardedGraph):
        return _topsim_sharded(g, mesh, cfg, key, sources, device_capacity, route_slack)
    axis = mesh.axis_names[0]
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group, dev = mesh.groups[axis], mesh.device
    g = g.to(dev)
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    n = len(sources)
    per_dev = min(cfg.source_tile, max(1, -(-n // n_dev)))
    cap = frontier_capacity(g, cfg)
    out_vals = np.zeros((n, cfg.topk), np.float32)
    out_idx = np.zeros((n, cfg.topk), np.int32)
    for lo, m, chunk in _source_windows(sources, per_dev * n_dev):
        src = torch.from_numpy(chunk[me * per_dev: (me + 1) * per_dev]).to(dev)
        targets, vals, _ = topsim_tile_items(g, src, per_device_key(key_for(key, lo), mesh, axis),
                                             cfg, cap)
        tv, ti = segment_topk(targets, vals, cfg.topk, g.n_nodes)
        out_vals[lo: lo + m] = gather_rows(tv, group).cpu().numpy()[:m]
        out_idx[lo: lo + m] = gather_rows(ti, group).cpu().numpy()[:m]
    return out_vals, out_idx


def _topsim_sharded(g: ShardedGraph, mesh, cfg: TopSimConfig, key: int,
                    sources: Optional[np.ndarray], device_capacity: Optional[int],
                    route_slack: float) -> Tuple[np.ndarray, np.ndarray]:
    """TopSim over a partitioned CSR: frontier items live at their current
    node's owner, expand against the local block, and the children route to
    their own owners each depth (``mySendMsg``,
    ``CombineBatchSingleWalkVertexReuse.java:139-161``); increments route to
    the source position's owner at the flush.  Per-rank state is
    O(window·w_cap/n · slack).  The mass that a full bucket or the flush
    drops is summed over the mesh; past 1e-3 of a window's budget the run
    raises."""
    axis = mesh.axis_names[0]
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group, dev = mesh.groups[axis], mesh.device
    sources = (np.arange(g.n_nodes, dtype=np.int32) if sources is None
               else np.asarray(sources, np.int32))
    n = len(sources)
    per_out = min(cfg.source_tile, max(1, -(-n // n_dev)))
    window = per_out * n_dev
    w_cap = cfg.frontier_capacity or (2 * math.ceil(cfg.sample) + 8)
    length = 2 * cfg.step + 1
    nodes_per = g.nodes_per
    # byte/short-packed wire formats (Short_2MixMsgWritable.java,
    # ByteArrayWritable.java): positions and node ids in the narrowest dtype
    wd_pos = narrowest_int_dtype(window - 1)
    wd_node = narrowest_int_dtype(g.n_nodes - 1)
    cap0 = device_capacity or int(math.ceil(route_slack * window * w_cap / n_dev))
    bucket = max(per_out, -(-cap0 // n_dev))
    cap = bucket * n_dev           # items a rank holds after an exchange
    exp_cap = 2 * cap              # expansion output slots
    inc_bucket = max(64, int(math.ceil(route_slack * cfg.step * exp_cap / n_dev)))
    g_loc = local_graph(g)
    degf = g.deg_global.float()
    e_last = g.e_cap - 1

    def run_window(src_l: torch.Tensor, kwin: int):
        kdev = per_device_key(kwin, mesh, axis)
        src_pos = me * per_out + torch.arange(per_out, dtype=torch.int32, device=dev)
        paths = torch.full((per_out, length), -1, dtype=torch.int32, device=dev)
        paths[:, 0] = src_l
        mass = torch.full((per_out,), float(cfg.sample), device=dev)
        inc_src, inc_tgt, inc_val = [], [], []
        lost = torch.zeros((), dtype=torch.float64, device=dev)  # this rank's share
        for depth in range(2 * cfg.step):
            # 1. route items to the owner of their current node
            cur = paths[:, depth]
            ok = (src_pos >= 0) & (cur >= 0) & (mass > 0)
            owner = torch.where(ok, cur // nodes_per, -1)
            lost += torch.where(ok, mass, 0.0).sum()
            payloads = (src_pos, mass) + tuple(paths[:, j] for j in range(depth + 1))
            recv, valid = exchange_by_owner(payloads, owner, group, n_dev, bucket,
                                            wire_dtypes=(wd_pos, None) + (wd_node,) * (depth + 1))
            r_pos = recv[0]
            r_mass = torch.where(valid, recv[1], 0.0)
            r_paths = torch.full((cap, length), -1, dtype=torch.int32, device=dev)
            for j in range(depth + 1):
                r_paths[:, j] = torch.where(valid, recv[2 + j], -1)
            lost -= r_mass.sum()

            # 2. expand against the LOCAL block (budget splitting)
            cur_g = r_paths[:, depth]
            loc = torch.where(cur_g >= 0, cur_g - me * nodes_per, -1)
            d = torch.where(loc >= 0, g_loc.deg[loc.clamp(min=0)], 0)
            active = (r_mass > 0) & (loc >= 0) & (d > 0)
            split = active & (r_mass >= d.float())
            nchild = torch.where(split, d, torch.ceil(r_mass).int())
            nchild = torch.where(active, nchild, 0).long()
            offs = torch.cumsum(nchild, 0) - nchild
            total = offs[-1] + nchild[-1]
            slots = torch.arange(exp_cap, device=dev)
            parent = (torch.searchsorted(offs, slots, right=True) - 1).clamp(0, cap - 1)
            rank = slots - offs[parent]
            p_n = nchild[parent]
            validc = (slots < total) & (rank >= 0) & (rank < p_n)
            p_loc = loc[parent]
            p_mass = r_mass[parent]
            p_split = split[parent]
            base = g_loc.row_ptr[p_loc.clamp(min=0)].long()
            split_node = g_loc.col[(base + rank).clamp(max=e_last)]
            samp_node = uniform_neighbor(g_loc, torch.where(validc, p_loc, -1),
                                         generator(key_for(kdev, depth), dev))
            node = torch.where(p_split, split_node, samp_node)
            node = torch.where(validc, node, -1)
            child_mass = torch.where(validc, p_mass / p_n.clamp(min=1), 0.0)
            c_paths = r_paths[parent]
            c_paths[:, depth + 1] = node
            c_paths = torch.where(validc[:, None], c_paths, -1)
            c_pos = torch.where(validc, r_pos[parent], -1)
            lost += torch.where(active, r_mass, 0.0).sum() - child_mass.sum()

            # 3. sim increments at even depths (first-meet rule)
            lvl = depth + 1
            if lvl % 2 == 0:
                i = lvl // 2
                inter, target = c_paths[:, i], c_paths[:, 2 * i]
                okk = (validc & (target >= 0) & (target != c_paths[:, 0])
                       & _first_meet_mask(c_paths[:, : 2 * i + 1], i))
                val = (child_mass * (cfg.c ** i) * degf[inter.clamp(min=0)]
                       / degf[target.clamp(min=0)].clamp(min=1.0))
                if cfg.normalize:
                    val = val / cfg.sample
                inc_src.append(torch.where(okk, c_pos, -1))
                inc_tgt.append(torch.where(okk, target, -1))
                inc_val.append(torch.where(okk, val, 0.0))
            src_pos, mass, paths = c_pos, child_mass, c_paths

        # 4. flush: route increments to the source position's owner and
        # reduce to top-k (scatter-free; the Giraph sim-message routing)
        a_src, a_tgt, a_val = torch.cat(inc_src), torch.cat(inc_tgt), torch.cat(inc_val)
        owner = torch.where(a_src >= 0, a_src // per_out, -1)
        per_owner = segment_sum_1d(owner, torch.ones_like(a_val), n_dev)
        lost += (per_owner - inc_bucket).clamp(min=0).sum()
        (f_src, f_tgt, f_val), fvalid = exchange_by_owner(
            (a_src, a_tgt, a_val), owner, group, n_dev, inc_bucket,
            wire_dtypes=(wd_pos, wd_node, None))
        f_val = torch.where(fvalid, f_val, 0.0)
        local_ids = me * per_out + torch.arange(per_out, dtype=torch.int32, device=dev)
        gv, gi = pair_topk_by_source(f_src.int(), f_tgt.int(), f_val, local_ids, cfg.topk)
        return gv, gi, float(psum(lost.reshape(1), group)[0])

    out_vals = np.zeros((n, cfg.topk), np.float32)
    out_idx = np.zeros((n, cfg.topk), np.int32)
    for lo, m, chunk in _source_windows(sources, window):
        src_l = torch.from_numpy(chunk[me * per_out: (me + 1) * per_out]).to(dev)
        gv, gi, lost = run_window(src_l, key_for(key, lo))
        if lost > 1e-3 * cfg.sample * window:
            raise RuntimeError(f"topsim shard exchange dropped {lost:.1f} mass; raise "
                               f"route_slack/device_capacity (bucket={bucket}, "
                               f"inc_bucket={inc_bucket})")
        out_vals[lo: lo + m] = gather_rows(gv, group).cpu().numpy()[:m]
        out_idx[lo: lo + m] = gather_rows(gi, group).cpu().numpy()[:m]
    return out_vals, out_idx
