"""Distributed second-order (p, q)-biased walks on a partitioned CSR
(counterpart of ``graphtpu/dist/node2vec_dist.py``).

node2vec's walker (``node2vec/src/node2vec.py:61-81``) needs TWO rows a hop:
cur's row (to propose) and prev's row (the triangle test ``edge(prev, x)``).
They live on different owners, so each hop ships the membership probes
with the exchange:

  1. route walkers (wid, prev, cur) to owner(cur), which proposes a T-panel
     of neighbours from its LOCAL rows (rejection sampling, the panel
     scheme of :mod:`graphtpu_torch.walks.node2vec`);
  2. route (wid, prev, proposals) to owner(prev), which answers the probes
     against prev's LOCAL row (sorted-row bisection), computes the bias
     and accepts the first surviving proposal;
  3. route (wid, next) home.

Three exchanges a hop; no rank reads a remote row.  With a replicated
graph, use the single-device walker.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphtpu_torch.core.prng import generator, key_for, per_device_key
from graphtpu_torch.dist.frontier import (
    _local_rows,
    exchange_by_owner,
    narrowest_int_dtype,
    random_starts,
)
from graphtpu_torch.dist.sharded_graph import ShardedGraph, local_cumulative_weights, local_graph
from graphtpu_torch.kernels.sampling import (
    edge_exists,
    uniform_neighbor,
    weighted_neighbor,
)
from graphtpu_torch.walks.node2vec import default_max_trials


def distributed_node2vec_walks(
    g: ShardedGraph,
    n_walkers: int,
    num_steps: int,
    p: float,
    q: float,
    key: int,
    mesh,
    starts=None,
    max_trials: Optional[int] = None,
    weighted: bool = False,
) -> torch.Tensor:
    """This rank's rows of the int32 [n_walkers, num_steps+1] walks; the
    first hop first-order, later hops second-order (statistical parity with
    :func:`graphtpu_torch.walks.node2vec.node2vec_walks`).  ``g`` is this
    rank's block; ``starts`` the global start nodes (default: uniform from
    ``key``).  Hop s draws from ``key_for(per_device_key(key), s, 0)``
    (proposals) and ``(s, 1)`` (acceptance)."""
    if not isinstance(g, ShardedGraph):
        raise TypeError("distributed_node2vec_walks takes a ShardedGraph block")
    inv_p, inv_q = 1.0 / p, 1.0 / q
    qmax = max(inv_p, 1.0, inv_q)
    t = max_trials if max_trials is not None else default_max_trials(p, q)
    axis = mesh.axis_names[0]
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group, dev = mesh.groups[axis], mesh.device
    if n_walkers % n_dev:
        raise ValueError(f"{n_walkers} walkers do not split over {n_dev} ranks")
    per_dev = n_walkers // n_dev
    nodes_per = g.nodes_per
    base = me * nodes_per
    use_w = weighted and g.weight is not None
    if starts is None:
        starts = random_starts(key, n_walkers, g.n_nodes)
    wid_l = torch.arange(me * per_dev, (me + 1) * per_dev, dtype=torch.int32, device=dev)
    # byte/short-packed wire formats (BatchSingleWalkVertex_Byte.java)
    wd_wid = narrowest_int_dtype(n_walkers - 1)
    wd_node = narrowest_int_dtype(g.n_nodes - 1)
    g_loc = local_graph(g)
    cumw = local_cumulative_weights(g_loc) if use_w else None
    kdev = per_device_key(key, mesh, axis)

    def sample_local(loc, gen):
        if use_w:
            return weighted_neighbor(g_loc, cumw, loc, gen)
        return uniform_neighbor(g_loc, loc, gen)

    def route_home(r_wid, nxt, walks, step_idx):
        home = torch.where(r_wid >= 0, r_wid // per_dev, -1)
        (h_wid, h_nxt), ok = exchange_by_owner((r_wid, nxt), home, group, n_dev, per_dev,
                                               wire_dtypes=(wd_wid, wd_node))
        walks[(h_wid[ok] % per_dev).long(), step_idx] = h_nxt[ok]

    walks = torch.full((per_dev, num_steps + 1), -1, dtype=torch.int32, device=dev)
    walks[:, 0] = _local_rows(starts, me, per_dev, dev)
    if num_steps < 1:
        return walks
    # hop 1: first-order (alias_nodes semantics, node2vec.py:28-29)
    cur = walks[:, 0]
    (r_wid, r_cur), _ = exchange_by_owner(
        (wid_l, cur), torch.where(cur >= 0, cur // nodes_per, -1), group, n_dev, per_dev,
        wire_dtypes=(wd_wid, wd_node))
    nxt = sample_local(torch.where(r_cur >= 0, r_cur - base, -1),
                       generator(key_for(kdev, 0, 0), dev))
    route_home(r_wid, nxt, walks, 1)

    for s in range(1, num_steps):
        prev, cur = walks[:, s - 1], walks[:, s]
        ok = cur >= 0
        # (1) propose a T-panel at cur's owner
        (r_wid, r_prev, r_cur), _ = exchange_by_owner(
            (torch.where(ok, wid_l, -1), prev, cur), torch.where(ok, cur // nodes_per, -1),
            group, n_dev, per_dev, wire_dtypes=(wd_wid, wd_node, wd_node))
        loc = torch.where(r_cur >= 0, r_cur - base, -1)
        props = sample_local(loc[:, None].expand(-1, t).contiguous(),
                             generator(key_for(kdev, s, 0), dev))  # [N, T] global ids
        # (2) ship the probes to prev's owner; a cur-owner can hold every
        # walker and they may share one prev-owner, so the buckets are
        # full-width
        powner = torch.where((r_wid >= 0) & (r_prev >= 0), r_prev // nodes_per, -1)
        payloads = (r_wid, r_prev) + tuple(props[:, j] for j in range(t))
        recv, _ = exchange_by_owner(payloads, powner, group, n_dev, n_dev * per_dev,
                                    wire_dtypes=(wd_wid,) + (wd_node,) * (len(payloads) - 1))
        q_wid, q_prev = recv[0], recv[1]
        q_props = torch.stack(recv[2:], dim=1)  # [N, T]
        ploc = torch.where(q_prev >= 0, q_prev - base, -1)
        is_ret = q_props == q_prev[:, None]
        is_tri = edge_exists(g_loc, ploc[:, None], q_props)
        bias = torch.where(is_ret, inv_p, torch.where(is_tri, 1.0, inv_q))
        u = torch.rand(q_props.shape, generator=generator(key_for(kdev, s, 1), dev), device=dev)
        acc = (u < bias / qmax) | (q_props < 0)
        idx = torch.where(acc.any(dim=1), acc.int().argmax(dim=1), t - 1)
        nxt = q_props.gather(1, idx[:, None])[:, 0]
        # (3) home
        route_home(q_wid, torch.where(q_wid >= 0, nxt, -1), walks, s + 1)
    return walks
