"""Double-walk Monte-Carlo SimRank (counterpart of
``graphtpu/simrank/doublewalk.py``).

Reference (``simrank/DoubleRandomWalk.java:50-91``): pre-sample SAMPLE
walks of STEP hops per node (``paths[v][s][t]`` = node after t+1 hops);
sim(v, w) = (1/SAMPLE^2) * sum over all walk pairs of C^(t+1), where t is
the first step at which the two walks coincide (the scan breaks at the
first -1 or the first meeting).

All walks are one [V, S, STEP] tensor from one batched walk call.  The
pairing loop is blocked over (T1, T2) source-pair tiles: equality tensors
of the two tiles' walks at each step, with a carried "already met" mask,
sum the first-meet weights exactly as the reference's break (walks never
revive after -1, and -1 never equals anything).  At STEP 1 first-meet is
endpoint equality, so the similarity is a product of endpoint histograms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphtpu_torch.core.config import DoubleWalkConfig
from graphtpu_torch.core.device import full_fp32, resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.walks.walker import uniform_walks


def sample_double_walk_paths(
    g: Graph, sample: int, step: int, key: int, device=None
) -> torch.Tensor:
    """int32 [V, SAMPLE, STEP]: the node after t+1 hops (-1 once dead), on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    v = g.n_nodes
    starts = torch.repeat_interleave(torch.arange(v, dtype=torch.int32, device=dev), sample)
    walks = uniform_walks(g, starts, step, key, device=dev)
    return walks[:, 1:].reshape(v, sample, step)


def _pair_block(pi: torch.Tensor, pj: torch.Tensor, c: float) -> torch.Tensor:
    """[Ti, S, L] x [Tj, S, L] walks -> [Ti, Tj] mean first-meet weight."""
    s, steps = pi.shape[1], pi.shape[2]
    met = torch.zeros((pi.shape[0], pj.shape[0], s, s), dtype=torch.bool, device=pi.device)
    acc = torch.zeros((pi.shape[0], pj.shape[0]), dtype=torch.float32, device=pi.device)
    for t in range(steps):
        a = pi[:, None, :, None, t]
        eq = (a == pj[None, :, None, :, t]) & (a >= 0)
        acc = acc + (c ** (t + 1)) * (eq & ~met).sum(dim=(2, 3)).float()
        met |= eq
    return acc / (s * s)


def _pad_rows(paths: torch.Tensor, rows: int) -> torch.Tensor:
    """``paths`` padded with -2 rows (which meet nothing) to ``rows``."""
    if rows == paths.shape[0]:
        return paths
    pad = paths.new_full((rows - paths.shape[0], *paths.shape[1:]), -2)
    return torch.cat([paths, pad])


def doublewalk_simrank(
    g: Graph,
    cfg: DoubleWalkConfig = DoubleWalkConfig(),
    key: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Dense [V, V] similarity (diag zeroed), the reference estimator, on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = g.to(dev)
    v = g.n_nodes
    paths = sample_double_walk_paths(g, cfg.sample, cfg.step, 0 if key is None else key, dev)
    tile = min(cfg.source_tile, v)
    n_tiles = -(-v // tile)
    paths_p = _pad_rows(paths, n_tiles * tile).reshape(n_tiles, tile, cfg.sample, cfg.step)
    sim = np.zeros((n_tiles * tile, n_tiles * tile), np.float32)
    for bi in range(n_tiles):
        for bj in range(bi, n_tiles):
            blk = _pair_block(paths_p[bi], paths_p[bj], cfg.c).cpu().numpy()
            sim[bi * tile:(bi + 1) * tile, bj * tile:(bj + 1) * tile] = blk
            if bj != bi:
                sim[bj * tile:(bj + 1) * tile, bi * tile:(bi + 1) * tile] = blk.T
    sim = sim[:v, :v]
    np.fill_diagonal(sim, 0.0)
    return sim


def endpoint_counts(ends: torch.Tensor, v: int) -> torch.Tensor:
    """float32 [R, V] histogram of each row's endpoints (-1 = dead, skipped):
    integer counts, exact."""
    r = ends.shape[0]
    rows = torch.arange(r, device=ends.device)[:, None]
    keys = torch.where(ends >= 0, rows * v + ends, r * v).reshape(-1)
    return torch.bincount(keys, minlength=r * v + 1)[: r * v].reshape(r, v).float()


def step1_mass_sim(
    ends: torch.Tensor, sources: torch.Tensor, v: int, c: float, s_active: int
) -> torch.Tensor:
    """[n_src, V] one-hop endpoint-mass similarity from the first
    ``s_active`` columns of ``ends`` (int32 [V, S_total]; -1 = dead).

    sim(r, w) = c / s_active^2 * <cnt_r, cnt_w>, with cnt the endpoint
    histogram over the active walks: one product of histograms in full
    float32.  Counts are integers and their products' sums stay below 2^24,
    so the product is exact."""
    active = torch.arange(ends.shape[1], device=ends.device) < s_active
    cnt = endpoint_counts(torch.where(active[None, :], ends, -1), v)
    with full_fp32():
        acc = cnt[sources.long()] @ cnt.T
    denom = torch.tensor(float(s_active), dtype=torch.float32) ** 2
    return (torch.tensor(c, dtype=torch.float32) / denom).to(acc.device) * acc


def doublewalk_simrank_rows(
    g: Graph,
    cfg: DoubleWalkConfig = DoubleWalkConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """[n_src, V] double-walk similarity rows for a source subset, the sweep
    protocol's form (``Test_u_u_doubleRandomWalk_Sample.java:32-43``), on
    ``device`` (default ``cuda``).

    At ``step == 1`` the estimator factorises exactly: first-meet is
    endpoint equality after one hop, so sim(v, w) = C / S^2 * <cnt_v,
    cnt_w> (:func:`step1_mass_sim`).  Longer walks take the blocked pair
    computation with row tiles drawn from ``sources``."""
    dev = resolve_device(device)
    g = g.to(dev)
    v = g.n_nodes
    sources = np.arange(v, dtype=np.int32) if sources is None else np.asarray(sources, np.int32)
    paths = sample_double_walk_paths(g, cfg.sample, cfg.step, 0 if key is None else key, dev)
    src = torch.from_numpy(sources).to(dev)
    if cfg.step == 1:
        sim = step1_mass_sim(paths[:, :, 0], src, v, cfg.c, cfg.sample).cpu().numpy()
    else:
        n = len(sources)
        tile = min(cfg.source_tile, n)
        ct = min(cfg.source_tile, v)
        nc = -(-v // ct)
        paths_c = _pad_rows(paths, nc * ct).reshape(nc, ct, cfg.sample, cfg.step)
        sim = np.zeros((n, nc * ct), np.float32)
        for lo in range(0, n, tile):
            pi = paths[src[lo:lo + tile].long()]
            for bj in range(nc):
                sim[lo:lo + tile, bj * ct:(bj + 1) * ct] = (
                    _pair_block(pi, paths_c[bj], cfg.c).cpu().numpy())
        sim = sim[:, :v]
    sim[np.arange(len(sources)), sources] = 0.0
    return sim
