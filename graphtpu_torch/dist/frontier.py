"""Frontier exchange, the BSP message-routing primitive (counterpart of
``graphtpu/dist/frontier.py``).

In the reference, walkers move between machines as Giraph vertex messages
with a global superstep barrier (``giraph/SingleWalkVertex.java:66-89``).
Here a superstep is one collective: rows are bucketed by owner rank into
fixed-capacity buckets and exchanged with one all-to-all
(:func:`exchange_by_owner`).  Anything that sends per-node state across a
partitioned graph (walker frontiers, sim increments, TopSim mass) goes
through it.

:func:`distributed_uniform_walks` runs the Giraph walk cycle on a mesh:
route walkers to the owner of their current node, step there, route the
result back to the walker's home rank, two exchanges a hop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.prng import generator, key_for, per_device_key
from graphtpu_torch.dist.mesh import all_to_all
from graphtpu_torch.dist.sharded_graph import ShardedGraph, local_cumulative_weights, local_graph
from graphtpu_torch.kernels.sampling import (
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)


def narrowest_int_dtype(max_value: int) -> torch.dtype:
    """Narrowest SIGNED int dtype holding [-1, max_value]: the wire format
    picker.  The reference's 1M-vertex run byte/short-packs walker messages
    (``giraph/BatchSingleWalkVertex_Byte.java:38-51``); here the exchange
    ships int8/int16 buckets when the id range fits."""
    if max_value < 2 ** 7:
        return torch.int8
    if max_value < 2 ** 15:
        return torch.int16
    return torch.int32


# collective payload bytes this process has sent: graphtpu counts each
# exchange once when jax traces it; this counts every exchange run
_wire_stats = {"bytes": 0, "bytes_unpacked": 0, "exchanges": 0}


def reset_wire_stats() -> None:
    _wire_stats.update(bytes=0, bytes_unpacked=0, exchanges=0)


def wire_stats() -> dict:
    """Bytes this rank shipped in exchange buckets (``bytes``), what the
    same buckets would have taken in the payloads' own dtypes
    (``bytes_unpacked``), and the exchanges run, since the last reset."""
    return dict(_wire_stats)


def _bucket_route(owner: torch.Tensor, n_dev: int, capacity: int):
    """The routing of one exchange, computed once for every payload: the
    stable owner sort, each row's rank within its owner, and validity.
    Returns (order, bucket rows, bucket columns, ok) in sorted order;
    rows past an owner's ``capacity`` and rows with owner < 0 are not ok."""
    n = owner.shape[0]
    owner_c = torch.where(owner < 0, n_dev, owner.long())
    order = torch.argsort(owner_c, stable=True)  # keeps arrival order
    sorted_owner = owner_c[order]
    idx = torch.arange(n, device=owner.device)
    start = torch.searchsorted(sorted_owner, torch.arange(n_dev + 1, device=owner.device))
    rank = idx - start[sorted_owner.clamp(max=n_dev)]
    ok = (sorted_owner < n_dev) & (rank < capacity)
    return order, sorted_owner, rank, ok


def _pack_routed(payload: torch.Tensor, route, n_dev: int, capacity: int, fill) -> torch.Tensor:
    """[N, ...] payload -> [n_dev, capacity, ...] buckets by owner; rows that
    are not ok are dropped."""
    order, rows, cols, ok = route
    buckets = torch.full((n_dev, capacity) + tuple(payload.shape[1:]), fill,
                         dtype=payload.dtype, device=payload.device)
    buckets[rows[ok], cols[ok]] = payload[order][ok]
    return buckets


def _pack_buckets(payload: torch.Tensor, owner: torch.Tensor, n_dev: int, capacity: int,
                  fill) -> torch.Tensor:
    """[N] payload -> [n_dev, capacity] buckets by owner (overflow drops;
    owner < 0 marks rows to drop)."""
    return _pack_routed(payload, _bucket_route(owner, n_dev, capacity), n_dev, capacity, fill)


def exchange_by_owner(
    payloads: Tuple[torch.Tensor, ...],
    owner: torch.Tensor,
    group,
    n_dev: int,
    capacity: int,
    fill: int = -1,
    wire_dtypes: Optional[Tuple] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Route [N]-rows to their owner rank over the process ``group`` (n_dev
    ranks; graphtpu names a mesh axis).

    Returns the received payloads, each [n_dev * capacity] in sender order,
    and a validity mask (first payload != ``fill``).  Rows past a bucket's
    ``capacity`` are dropped; callers size it so that this does not happen,
    as the reference sizes Giraph heaps.

    ``wire_dtypes``: per payload, a dtype to ship it in (None keeps its
    own); integers whose range fits go as int8/int16 and are widened back,
    floats may go as bfloat16.  Payloads of one (wire, own) dtype pair ship
    stacked in one all-to-all."""
    if wire_dtypes is None:
        wire_dtypes = (None,) * len(payloads)
    if len(wire_dtypes) != len(payloads):
        raise ValueError("one wire dtype per payload")
    route = _bucket_route(owner, n_dev, capacity)
    groups: dict = {}
    for i, (pay, wd) in enumerate(zip(payloads, wire_dtypes)):
        groups.setdefault((wd or pay.dtype, pay.dtype), []).append(i)
    outs: list = [None] * len(payloads)
    for (wire, orig), idxs in groups.items():
        stacked = torch.stack([payloads[i].to(wire) for i in idxs], dim=-1)  # [N, k]
        k = len(idxs)
        buckets = _pack_routed(stacked, route, n_dev, capacity, fill)
        _wire_stats["bytes"] += buckets.numel() * buckets.element_size()
        _wire_stats["bytes_unpacked"] += buckets.numel() * orig.itemsize
        recv = all_to_all(buckets, group).reshape(-1, k).to(orig)  # [n_dev * capacity, k]
        for j, i in enumerate(idxs):
            outs[i] = recv[:, j]
    _wire_stats["exchanges"] += 1
    valid = outs[0] != fill if outs else None
    return tuple(outs), valid


def random_starts(key: int, n_walkers: int, n_nodes: int) -> torch.Tensor:
    """int32 [n_walkers] uniform start nodes from ``key``, drawn on the host so
    every rank draws the same."""
    gen = generator(key_for(key, 0), "cpu")
    return torch.randint(0, n_nodes, (n_walkers,), generator=gen, dtype=torch.int32)


def _local_rows(x, me: int, per: int, device) -> torch.Tensor:
    """Rows [me*per, (me+1)*per) of a global array, as int32 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x[me * per: (me + 1) * per].to(device=device, dtype=torch.int32)


def distributed_uniform_walks(
    g,
    n_walkers: int,
    num_steps: int,
    key: int,
    mesh,
    starts=None,
    weighted: bool = False,
) -> torch.Tensor:
    """This rank's rows of the [n_walkers, num_steps+1] walk tensor, one
    owner exchange and one home exchange a hop.

    Node ownership is by contiguous range; walker w lives on home rank
    ``w // (n_walkers / n)``, which assembles its path.  ``g`` is a
    replicated :class:`Graph` or this rank's :class:`ShardedGraph` block;
    with a block each rank samples against only its own CSR rows after the
    owner exchange, so the whole adjacency is on no rank.  With one key both
    forms give the same walks: routing, bucket order and each owner's
    stream (``key_for(per_device_key(key), t)`` at hop t) are shared, only
    where the rows are read differs.  ``starts``: the global start nodes
    (default: uniform from ``key``).  Returns rows [me*B/n, (me+1)*B/n) on
    the mesh's device (:func:`graphtpu_torch.dist.mesh.gather_rows` joins
    them)."""
    axis = mesh.axis_names[0]
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)
    group, dev = mesh.groups[axis], mesh.device
    if n_walkers % n_dev:
        raise ValueError(f"{n_walkers} walkers do not split over {n_dev} ranks")
    per_dev = n_walkers // n_dev
    sharded = isinstance(g, ShardedGraph)
    nodes_per = g.nodes_per if sharded else -(-g.n_nodes // n_dev)
    if starts is None:
        starts = random_starts(key, n_walkers, g.n_nodes)
    starts_l = _local_rows(starts, me, per_dev, dev)
    wid_l = torch.arange(me * per_dev, (me + 1) * per_dev, dtype=torch.int32, device=dev)
    # byte/short-packed wire formats when the id ranges fit
    # (BatchSingleWalkVertex_Byte.java:38-51)
    wd_wid = narrowest_int_dtype(n_walkers - 1)
    wd_node = narrowest_int_dtype(g.n_nodes - 1)
    use_w = weighted and g.weight is not None
    if sharded:
        g_loc, base = local_graph(g), me * nodes_per
    else:
        g_loc, base = g.to(dev), 0
    cumw = None
    if use_w:
        cumw = local_cumulative_weights(g_loc) if sharded else row_cumulative_weights(g_loc)
    kdev = per_device_key(key, mesh, axis)

    walks = torch.full((per_dev, num_steps + 1), -1, dtype=torch.int32, device=dev)
    walks[:, 0] = starts_l
    for t in range(num_steps):
        cur = walks[:, t]
        owner = torch.where(cur >= 0, cur // nodes_per, -1)
        (r_wid, r_cur), _ = exchange_by_owner((wid_l, cur), owner, group, n_dev, per_dev,
                                              wire_dtypes=(wd_wid, wd_node))
        # owner-local ids: every routed walker's node is this rank's
        loc = torch.where(r_cur >= 0, r_cur - base, -1)
        gen = generator(key_for(kdev, t), dev)
        if use_w:
            nxt = weighted_neighbor(g_loc, cumw, loc, gen)
        else:
            nxt = uniform_neighbor(g_loc, loc, gen)
        home = torch.where(r_wid >= 0, r_wid // per_dev, -1)
        (h_wid, h_nxt), ok = exchange_by_owner((r_wid, nxt), home, group, n_dev, per_dev,
                                               wire_dtypes=(wd_wid, wd_node))
        walks[(h_wid[ok] % per_dev).long(), t + 1] = h_nxt[ok]
    return walks
