"""Meeting-probability SimRank estimators, TopSim_doubleSample and
TopSim_Dev (counterpart of ``graphtpu/simrank/meeting.py``).

``TopSim_doubleSample`` (``simrank/TopSim_doubleSample.java:20-210``) runs
one budget-splitting walk per source, records the endpoint mass reaching
each node at each step, and scores

    sim(v, w) = sum_t C^t * sum_i mass_v[i, t] * mass_w[i, t]

(``getSim :196-210``).  With the even split dominating, the endpoint mass
is the t-step transition distribution M_t = e_v (D^-1 A)^t, so the dense
form is sum_t C^t M_t M_t^T.

``TopSim_Dev`` (``simrank/TopSim_Dev.java:24-268``) is two-phase:
single-walk spreading scores pick the top ``singleK`` candidates per
source (:func:`topsim_simrank`), then each candidate pair is re-scored
with the endpoint-mass product.  Masses are normalised to probabilities,
which leaves rankings unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.device import full_fp32, matmul_precision as precision, resolve_device
from graphtpu_torch.core.graph import Graph, dense_adjacency, row_normalized
from graphtpu_torch.simrank.doublewalk import endpoint_counts
from graphtpu_torch.walks.walker import uniform_walks


def _meeting_similarity(p_row: torch.Tensor, c: float, step: int) -> torch.Tensor:
    """sum_t C^t M_t M_t^T with M_t = M_{t-1} @ P (P row-stochastic)."""
    v = p_row.shape[0]
    m = torch.eye(v, dtype=p_row.dtype, device=p_row.device)
    sim = torch.zeros_like(m)
    for t in range(1, step + 1):
        m = m @ p_row
        sim = sim + (c ** t) * (m @ m.T)
    return sim


def doublesample_similarity(
    g: Graph, cfg: TopSimConfig = TopSimConfig(), matmul_precision: str = "high", device=None
) -> np.ndarray:
    """Dense [V, V] meeting-probability similarity (diag zeroed) on
    ``device`` (default ``cuda``).  ``matmul_precision`` takes graphtpu's
    names (:data:`graphtpu_torch.core.device.MATMUL_TF32`); its default
    "high", like "highest", is full float32, "default" allows TF32."""
    p_row = row_normalized(dense_adjacency(g, device=resolve_device(device)))
    with precision(matmul_precision):
        sim = _meeting_similarity(p_row, cfg.c, cfg.step)
    return sim.fill_diagonal_(0.0).cpu().numpy()


def doublesample_similarity_mc(
    g: Graph,
    sample: int,
    cfg: TopSimConfig = TopSimConfig(),
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """[n_src, V] sampled endpoint-mass similarity, the finite-budget regime
    of ``TopSim_doubleSample`` (active sweep grid {5, 10, 50}, step 1:
    ``benchmark/Test_u_u_TopSim_doubleSample.java:38-40``), on ``device``
    (default ``cuda``).

    Each node runs ``sample`` walks; with m_v[i, t] = #walks of v at node i
    after t hops / sample, sim(v, w) = sum_t C^t <m_v[:, t], m_w[:, t]>: a
    product of endpoint histograms per hop, in full float32."""
    dev = resolve_device(device)
    g = g.to(dev)
    v = g.n_nodes
    sources = np.arange(v, dtype=np.int32) if sources is None else np.asarray(sources, np.int32)
    src = torch.from_numpy(sources).to(dev).long()
    starts = torch.repeat_interleave(torch.arange(v, dtype=torch.int32, device=dev), sample)
    walks = uniform_walks(g, starts, cfg.step, 0 if key is None else key, device=dev)
    pos = walks[:, 1:].reshape(v, sample, cfg.step)
    acc = torch.zeros((len(sources), v), dtype=torch.float32, device=dev)
    with full_fp32():
        for t in range(cfg.step):
            cnt = endpoint_counts(pos[:, :, t], v)
            acc = acc + (cfg.c ** (t + 1)) * (cnt[src] @ cnt.T)
    sim = (acc / (sample * sample)).cpu().numpy()
    sim[np.arange(len(sources)), sources] = 0.0
    return sim


def topsim_dev(
    g: Graph,
    cfg: TopSimConfig = TopSimConfig(),
    single_k: int = 10,
    key: Optional[int] = None,
    sources: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-phase TopSim_Dev: spreading-walk candidates, meeting-score
    verification, on ``device`` (default ``cuda``).  Returns (values [N,
    topk], indices [N, topk]) for all sources or the given subset
    (``Test_u_u_TopSim_Dev.java:38-40`` scores a source sample).  Equal
    verified scores keep the candidates' order."""
    from graphtpu_torch.simrank.topsim import topsim_simrank

    cand_vals, cand_idx = topsim_simrank(
        g,
        TopSimConfig(
            c=cfg.c, step=cfg.step, sample=cfg.sample,
            topk=max(single_k, cfg.topk), source_tile=cfg.source_tile,
            frontier_capacity=cfg.frontier_capacity, normalize=cfg.normalize,
        ),
        key=key, sources=sources, device=device,
    )
    sim = doublesample_similarity(g, cfg, device=device)
    if sources is not None:
        sim = sim[np.asarray(sources)]
    n, k = cand_idx.shape
    rows = np.repeat(np.arange(n), k)
    cols = cand_idx.reshape(-1)
    verified = np.where(cols >= 0, sim[rows, np.maximum(cols, 0)], -np.inf).reshape(n, k)
    order = np.argsort(-verified, axis=1, kind="stable")[:, : cfg.topk]
    out_idx = np.take_along_axis(cand_idx, order, axis=1)
    out_val = np.take_along_axis(verified, order, axis=1)
    return np.where(np.isfinite(out_val), out_val, 0.0).astype(np.float32), out_idx
