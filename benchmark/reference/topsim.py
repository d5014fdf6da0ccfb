"""Plain TopSim in float64: the benchmark's reference for TopSim's
deterministic spreading (the reference's ``TopSim_singleSample.java:62-203``),
over the frontiers it is given.

A frontier at depth d holds a source tile's paths [T, W, 2·STEP+1] (column 0
each row's source) with a mass each [T, W]: a slot holds a path while its
mass is above 0, its nodes 0..d set and the rest -1; an empty slot reads -1
and mass 0.  The order of a row's slots is free.

:func:`spread_bad` holds each depth's transition to the spreading rule.  A
parent of mass s at node u of degree d >= 1 has

* where s >= d: exactly d children, one at each neighbour of u, each
  carrying s/d (``:99-124``);
* else: ceil(s) children, each at a neighbour of u, each carrying
  s/ceil(s) (``:126-149``);

and each child's path is its parent's with the child's node appended.  A
parent at a node with no neighbour has no child.  Parents with one path
share their mass, so the rule is checked per group of equal paths.

:func:`scores` is the estimator: a live path at depth 2i whose prefix
0..2i is first-meet (path[j] != path[2i-j] for every j < i, which at j = 0
leaves the source itself out) adds

    mass · C^i · deg(path[i]) / deg(path[2i]) / SAMPLE

to its row's column path[2i], into a dense [T, V] float64 tile by
``index_add_``.  Plain PyTorch, TF32 off; it works from the edges and
imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

RTOL = 1e-6  # a child's mass against s/n: the program divides in float32 (2^-24)


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def adjacency(edges: np.ndarray, n_nodes: int):
    """(sorted int64 keys u·V + x, one for each distinct neighbour x of each
    node u of the undirected graph (each pair mirrored, duplicates
    collapsed), and the degrees int64 [V])."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    key = np.unique(np.concatenate([e[:, 0] * n_nodes + e[:, 1], e[:, 1] * n_nodes + e[:, 0]]))
    return key, np.bincount(key // n_nodes, minlength=n_nodes)


def _shape_bad(paths: torch.Tensor, mass: torch.Tensor, depth: int) -> int:
    """Slots that are neither a live path of ``depth`` hops (mass above 0,
    nodes 0..depth set, the rest -1) nor empty (mass 0, every node -1)."""
    live = mass > 0
    set_ = paths[:, :, : depth + 1] >= 0
    rest = paths[:, :, depth + 1:] == -1
    good_live = live & set_.all(dim=2) & rest.all(dim=2)
    good_empty = (mass == 0) & (paths == -1).all(dim=2)
    return int((~(good_live | good_empty)).sum())


def _step_bad(parent, child, depth: int, keys: torch.Tensor, deg: torch.Tensor,
              n_nodes: int) -> int:
    """The children of depth + 1 that break the spreading rule, and the
    children the rule wants and the frontier lacks."""
    (pp, pm), (cp, cm) = parent, child
    t = pp.shape[0]
    rows = torch.arange(t, device=pp.device)[:, None].expand(pp.shape[:2])
    s = pm.double()
    u = pp[:, :, depth].long()
    du = deg[u.clamp(min=0)]
    act = (s > 0) & (du > 0)
    split = act & (s >= du)
    n = torch.where(split, du, torch.ceil(s).long())
    live = cm > 0
    pkey = torch.cat([rows[act][:, None], pp[act][:, : depth + 1].long()], dim=1)
    ckey = torch.cat([rows[live][:, None], cp[live][:, : depth + 1].long()], dim=1)
    groups, inv = torch.unique(torch.cat([pkey, ckey]), dim=0, return_inverse=True)
    ng, na = groups.shape[0], pkey.shape[0]
    pg, cg = inv[:na], inv[na:]
    kp = torch.bincount(pg, minlength=ng)
    s_a = s[act]
    s_hi = torch.zeros(ng, dtype=torch.float64, device=s.device).scatter_reduce(
        0, pg, s_a, "amax", include_self=False)
    s_lo = torch.zeros_like(s_hi).scatter_reduce(0, pg, s_a, "amin", include_self=False)
    n_g = torch.zeros(ng, dtype=torch.int64, device=s.device).scatter(0, pg, n[act])
    split_g = torch.zeros(ng, dtype=torch.bool, device=s.device).scatter(0, pg, split[act])
    bad = int(kp[s_hi != s_lo].sum())  # parents of one path with unequal masses
    bad += int((torch.bincount(cg, minlength=ng) - kp * n_g).abs().sum())
    has = kp[cg] > 0
    x = cp[live][:, depth + 1].long()
    want = s_hi[cg] / n_g[cg].clamp(min=1)
    bad += int((has & ((cm[live].double() - want).abs() > RTOL * want)).sum())
    k = groups[cg, depth + 1] * n_nodes + x
    pos = torch.searchsorted(keys, k).clamp(max=max(keys.numel() - 1, 0))
    nbr = (x >= 0) & (keys.numel() > 0) & (keys[pos] == k)
    bad += int((has & ~nbr).sum())
    on_split = has & nbr & split_g[cg]
    pairs, cnt = torch.unique(torch.stack([cg[on_split], x[on_split]], dim=1), dim=0,
                              return_counts=True)
    bad += int((cnt - kp[pairs[:, 0]]).abs().sum())
    return bad


def spread_bad(frontiers, edges: np.ndarray, n_nodes: int, sample: float) -> int:
    """The slots of a tile's frontiers at depths 0, 1, ..., 2·STEP that break
    the spreading rule: a root other than one path of mass SAMPLE a row, a
    slot of another shape, a child another than the rule gives its parent,
    a child the rule wants that is not there."""
    keys, deg = adjacency(edges, n_nodes)
    dev = frontiers[0][0].device
    keys = torch.as_tensor(keys, device=dev)
    deg = torch.as_tensor(deg, device=dev)
    paths, mass = frontiers[0]
    live = mass > 0
    bad = _shape_bad(paths, mass, 0)
    bad += int((live.sum(dim=1) - 1).abs().sum()) + int((live & (mass != sample)).sum())
    for d in range(len(frontiers) - 1):
        bad += _shape_bad(*frontiers[d + 1], d + 1)
        bad += _step_bad(frontiers[d], frontiers[d + 1], d, keys, deg, n_nodes)
    return bad


def scores(frontiers, deg: np.ndarray, n_nodes: int, c: float, sample: float) -> torch.Tensor:
    """Dense float64 [T, V] estimates from the frontiers at depths 2, 4,
    ..., 2·STEP, on their device."""
    dev = frontiers[0][0].device
    t = frontiers[0][0].shape[0]
    d = torch.as_tensor(np.asarray(deg), dtype=torch.float64, device=dev)
    sim = torch.zeros((t, n_nodes), dtype=torch.float64, device=dev)
    with _no_tf32():
        for i, (paths, mass) in enumerate(frontiers, start=1):
            p = paths.long()
            w = mass.double()
            target = p[:, :, 2 * i]
            meet = (w > 0) & (target >= 0)
            for j in range(i):
                meet &= p[:, :, j] != p[:, :, 2 * i - j]
            val = w * (c ** i) * d[p[:, :, i].clamp(min=0)] / d[target.clamp(min=0)] / sample
            row = torch.arange(t, device=dev)[:, None].expand_as(target)
            sim.view(-1).index_add_(0, (row * n_nodes + target)[meet], val[meet])
    return sim
