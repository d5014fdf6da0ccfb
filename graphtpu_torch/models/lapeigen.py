"""Laplacian Eigenmaps, a spectral embedding (counterpart of
``graphtpu/models/lapeigen.py``).

Reference (``IsoMap_LE/LE.py:35-51``): a kNN heat-kernel affinity
W_ij = exp(-||xi-xj||^2 / t) over k = 10 neighbours, D = rowsum, the
eigenproblem of D^-1 (D - W), keeping the eigenvectors of the smallest
eigenvalues above 1e-5 (``LE.py:62-77``).  The SimRank-LE visualiser
(``IsoMap_LE/simRank.py:95-123``) does the same with W from SimRank top-k
values and a D += 1e-6 guard.

The generalised problem is symmetrised (D^-1 L ~ D^-1/2 L D^-1/2 with
y = D^-1/2 u) and solved by one float32 ``torch.linalg.eigh`` on the
device.  Eigenvectors are fixed only up to sign, and only where the
spectrum has a gap; each connected component's zero eigenvalue lies in
float32 noise near the 1e-5 floor.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import LEConfig
from graphtpu_torch.core.device import full_fp32, resolve_device


def knn_heat_affinity(x: torch.Tensor, k: int, t: float) -> torch.Tensor:
    """Symmetrised kNN heat-kernel weights (``LE.py:35-43``): squared
    distances from the Gram form, W_ij = exp(-d2/t) where d2 is at most the
    k-th smallest of row i (ties all kept), then max(W, W^T)."""
    with full_fp32():
        sq = torch.sum(x * x, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = d2.clamp(min=0.0)
    d2.fill_diagonal_(float("inf"))
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1]
    w = torch.where(d2 <= kth[:, None], torch.exp(-d2 / t), 0.0)
    return torch.maximum(w, w.T)


def normalized_laplacian(w: torch.Tensor, guard: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(I - D^-1/2 W D^-1/2, D^-1/2) with D = rowsum(W) + ``guard``; rows
    with no mass get D^-1/2 = 0."""
    d = torch.sum(w, dim=1) + guard
    d_isqrt = torch.where(d > 0, 1.0 / torch.sqrt(d.clamp(min=1e-30)), 0.0)
    lsym = torch.eye(w.shape[0], device=w.device) - (d_isqrt[:, None] * w) * d_isqrt[None, :]
    return lsym, d_isqrt


def laplacian_eigenmaps(
    w: torch.Tensor,
    out_dim: int = 2,
    eig_floor: float = 1e-5,
    guard: float = 0.0,
    stage_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve D^-1 (D - W) on W's device; return (Y [n, out_dim], the kept
    eigenvalues), the smallest above ``eig_floor``.  ``guard`` adds the
    simRank.py D += 1e-6 stabiliser for rows with no affinity mass.
    ``stage_times``: if a dict, receives the host seconds of "eigh"."""
    lsym, d_isqrt = normalized_laplacian(w, guard)
    if w.device.type == "cuda":
        torch.cuda.synchronize(w.device)
    t0 = time.perf_counter()
    evals, evecs = torch.linalg.eigh(lsym)            # ascending
    evals_np = evals.cpu().numpy()
    if stage_times is not None:
        stage_times["eigh"] = time.perf_counter() - t0
    keep = np.nonzero(evals_np > eig_floor)[0][:out_dim]
    y = d_isqrt[:, None] * evecs[:, torch.from_numpy(keep).to(w.device)]
    return y.cpu().numpy(), evals_np[keep]


def le_embed_points(
    x: np.ndarray, cfg: LEConfig = LEConfig(), device=None,
    stage_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The LE.py flow on ``device`` (default ``cuda``): points -> kNN heat
    kernel -> spectral embedding."""
    dev = resolve_device(device)
    w = knn_heat_affinity(torch.as_tensor(x, dtype=torch.float32).to(dev),
                          cfg.k_neighbors, cfg.heat_t)
    return laplacian_eigenmaps(w, cfg.out_dim, cfg.eig_floor, stage_times=stage_times)


def sim_dict_affinity(sim_dict, n_nodes: int) -> np.ndarray:
    """float32 [n, n] affinity from top-k SimRank values, symmetrised by max
    (``simRank.py:95-123``)."""
    w = np.zeros((n_nodes, n_nodes), np.float32)
    for src, pairs in sim_dict.items():
        for dst, val in pairs:
            w[src, dst] = val
    return np.maximum(w, w.T)


def le_embed_sim_dict(
    sim_dict, n_nodes: int, cfg: LEConfig = LEConfig(), device=None,
    stage_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The simRank.py flow on ``device`` (default ``cuda``): top-k SimRank
    values as affinities, D guarded by 1e-6."""
    dev = resolve_device(device)
    w = torch.from_numpy(sim_dict_affinity(sim_dict, n_nodes)).to(dev)
    return laplacian_eigenmaps(w, cfg.out_dim, cfg.eig_floor, guard=1e-6,
                               stage_times=stage_times)


def make_swiss_roll(n: int = 2000, seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """Swiss-roll point cloud (``LE.py:19-33``), float32 [n, 3] from numpy's
    generator on ``seed``; graphtpu's points for ``key=None`` are seed 0's."""
    rng = np.random.default_rng(seed)
    t = 1.5 * np.pi * (1 + 2 * rng.random(n))
    h = 21.0 * rng.random(n)
    x = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1)
    if noise:
        x += noise * rng.normal(size=x.shape)
    return x.astype(np.float32)
