"""Benchmark sweeps, the ``benchmark/Test_u_u_*`` analog
(counterpart of ``graphtpu/bench/sweep.py``).

The reference's QA is gold-standard sweeps: per dataset, run an
approximation over a sample grid and score precision@k and NDCG against
the naive-SimRank gold output (``Test_u_u_TopSim_singleSample.java:25-64``,
grid {1000, 2500, 5000, 10000, 20000, 40000} ``:38``).  Each sweep runs
its engine on ``device`` (default ``cuda``); the scoring is host Python.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from graphtpu_torch.core.config import (
    DoubleWalkConfig,
    SimRankConfig,
    TopSimConfig,
    UniWalkConfig,
)
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.eval.precision import ndcg_sim_dicts, precision_sim_dicts
from graphtpu_torch.utils.logging import Log

REFERENCE_SAMPLE_GRID = (1000, 2500, 5000, 10000, 20000, 40000)
# the other swept engines' active reference grids:
#   doubleRandomWalk: samples {5,10,50,100,200,400}, step 1
#     (Test_u_u_doubleRandomWalk_Sample.java:32-35)
#   TopSim_doubleSample: samples {5,10,50}, step 1
#     (Test_u_u_TopSim_doubleSample.java:38-40)
#   TopSim_Dev: samples {10000}, step 3 (Test_u_u_TopSim_Dev.java:38-40)
DOUBLEWALK_SAMPLE_GRID = (5, 10, 50, 100, 200, 400)
DOUBLESAMPLE_GRID = (5, 10, 50)
DEV_SAMPLE_GRID = (10000,)


def sim_matrix_to_dict(sim: np.ndarray, k: int, sources: Optional[np.ndarray] = None) -> Dict:
    """{source: [(id, score) ...]} of each row's top k positive scores."""
    rows = range(sim.shape[0]) if sources is None else sources
    out = {}
    for r, v in enumerate(rows):
        row = sim[v] if sources is None else sim[r]
        if k < row.shape[0]:
            # argpartition first: a full argsort per row dominates the gold's
            # wall time at large V
            cand = np.argpartition(-row, k)[:k]
            idx = cand[np.argsort(-row[cand])]
        else:
            idx = np.argsort(-row)[:k]
        out[int(v)] = [(int(i), float(row[i])) for i in idx if row[i] > 0]
    return out


def topk_to_dict(vals: np.ndarray, idx: np.ndarray, sources: Optional[np.ndarray] = None) -> Dict:
    """{source: [(id, score) ...]} of top-k arrays, padding and zeros dropped."""
    keys = range(vals.shape[0]) if sources is None else sources
    return {
        int(v): [(int(i), float(s)) for i, s in zip(idx[r], vals[r]) if i >= 0 and s > 0]
        for r, v in enumerate(keys)
    }


def gold_standard(
    g: Graph,
    iterations: int = 30,
    k: int = 1000,
    sources: Optional[np.ndarray] = None,
    impl: str = "dense",
    device=None,
) -> Dict:
    """The reference gold standard: naive SimRank, 30 iterations, top 1000
    per row (``Test_u_u_TopSim_singleSample.java:17-18``,
    ``Print.printByOrderAll``), on ``device`` (default ``cuda``).
    ``impl="spmm"`` runs the sparse products (same fixed point) for graphs
    past the dense range; ``sources`` restricts the rows emitted."""
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

    cfg = SimRankConfig(iterations=iterations)
    if impl == "spmm":
        sim = exact_simrank_spmm(g, cfg, device=device)
    else:
        sim = exact_simrank(g, cfg, device=device)
    if sources is not None:
        src = np.asarray(sources)
        sim = sim[torch.as_tensor(src, device=sim.device).long()]
        return sim_matrix_to_dict(sim.cpu().numpy(), k, sources=src)
    return sim_matrix_to_dict(sim.cpu().numpy(), k)


@dataclasses.dataclass
class SweepResult:
    algorithm: str
    sample: float
    precision: float
    ndcg: float
    seconds: float


def _score(algorithm, s, gold, approx, topk, seconds, log) -> SweepResult:
    r = SweepResult(algorithm, s, precision_sim_dicts(gold, approx, k=topk),
                    ndcg_sim_dicts(gold, approx, k=topk), seconds)
    if log:
        log.info(json.dumps(dataclasses.asdict(r)))
    return r


def sweep_uniwalk(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = REFERENCE_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 64,
    device=None,
) -> List[SweepResult]:
    from graphtpu_torch.simrank.uniwalk import uniwalk_simrank

    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = uniwalk_simrank(
            g, UniWalkConfig(sample=s, step=step, topk=topk, source_tile=source_tile),
            key=key, sources=sources, device=device,
        )
        approx = topk_to_dict(vals, idx, sources=sources)
        results.append(_score("uniwalk", s, gold, approx, topk, time.time() - t0, log))
    return results


def sweep_topsim(
    g: Graph,
    gold: Dict,
    samples: Sequence[float] = REFERENCE_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 16,
    device=None,
) -> List[SweepResult]:
    from graphtpu_torch.simrank.topsim import topsim_simrank

    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = topsim_simrank(
            g, TopSimConfig(sample=float(s), step=step, topk=topk, source_tile=source_tile),
            key=key, sources=sources, device=device,
        )
        approx = topk_to_dict(vals, idx, sources=sources)
        results.append(_score("topsim_singleSample", s, gold, approx, topk,
                              time.time() - t0, log))
    return results


def _step1_rows(ends, src, g, c, s):
    """[n_src, V] step-1 endpoint-mass rows from the first s walks, with
    each source's own column zeroed."""
    from graphtpu_torch.simrank.doublewalk import step1_mass_sim

    sim = step1_mass_sim(ends, src, g.n_nodes, c, s).cpu().numpy()
    sim[np.arange(len(src)), src.cpu().numpy()] = 0.0
    return sim


def sweep_doublewalk(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = DOUBLEWALK_SAMPLE_GRID,
    step: int = 1,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 64,
    device=None,
) -> List[SweepResult]:
    """DoubleRandomWalk sweep, ``Test_u_u_doubleRandomWalk_Sample.java``
    (active grid samples {5,10,50,100,200,400}, step 1).  At step 1 every
    grid point scores the first s columns of one walk tensor drawn at the
    grid's largest sample."""
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.simrank.doublewalk import (
        doublewalk_simrank_rows,
        sample_double_walk_paths,
    )

    dev = resolve_device(device)
    key = 0 if key is None else key
    shared = None
    if step == 1:
        smax = max(max(samples), max(DOUBLEWALK_SAMPLE_GRID))
        shared = sample_double_walk_paths(g, smax, 1, key, dev)[:, :, 0]
        src = torch.from_numpy(np.arange(g.n_nodes, dtype=np.int32) if sources is None
                               else np.asarray(sources, np.int32)).to(dev)
    results = []
    for s in samples:
        t0 = time.time()
        if shared is not None:
            sim = _step1_rows(shared, src, g, DoubleWalkConfig().c, s)
        else:
            sim = doublewalk_simrank_rows(
                g, DoubleWalkConfig(sample=s, step=step, source_tile=source_tile),
                key=key, sources=sources, device=dev,
            )
        approx = sim_matrix_to_dict(sim, topk, sources=sources)
        results.append(_score("doubleRandomWalk", s, gold, approx, topk,
                              time.time() - t0, log))
    return results


def sweep_doublesample(
    g: Graph,
    gold: Dict,
    samples: Sequence[int] = DOUBLESAMPLE_GRID,
    step: int = 1,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    device=None,
) -> List[SweepResult]:
    """TopSim_doubleSample sweep, ``Test_u_u_TopSim_doubleSample.java``
    (active grid samples {5,10,50}, step 1), sampled endpoint masses.  At
    step 1 the two engines' estimators coincide (the one-hop endpoint-mass
    product), so the grid shares one walk tensor as in
    :func:`sweep_doublewalk`."""
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.simrank.meeting import doublesample_similarity_mc
    from graphtpu_torch.walks.walker import uniform_walks

    dev = resolve_device(device)
    key = 0 if key is None else key
    shared = None
    if step == 1:
        smax = max(max(samples), max(DOUBLESAMPLE_GRID))
        starts = torch.repeat_interleave(
            torch.arange(g.n_nodes, dtype=torch.int32, device=dev), smax)
        shared = uniform_walks(g, starts, 1, key, device=dev)[:, 1].reshape(g.n_nodes, smax)
        src = torch.from_numpy(np.arange(g.n_nodes, dtype=np.int32) if sources is None
                               else np.asarray(sources, np.int32)).to(dev)
    results = []
    for s in samples:
        t0 = time.time()
        if shared is not None:
            sim = _step1_rows(shared, src, g, TopSimConfig().c, s)
        else:
            sim = doublesample_similarity_mc(g, s, TopSimConfig(step=step), key=key,
                                             sources=sources, device=dev)
        approx = sim_matrix_to_dict(sim, topk, sources=sources)
        results.append(_score("topsim_doubleSample", s, gold, approx, topk,
                              time.time() - t0, log))
    return results


def sweep_topsim_dev(
    g: Graph,
    gold: Dict,
    samples: Sequence[float] = DEV_SAMPLE_GRID,
    step: int = 3,
    topk: int = 20,
    log: Optional[Log] = None,
    key=None,
    sources: Optional[np.ndarray] = None,
    source_tile: int = 16,
    device=None,
) -> List[SweepResult]:
    """TopSim_Dev two-phase sweep, ``Test_u_u_TopSim_Dev.java`` (active grid
    samples {10000}, step 3)."""
    from graphtpu_torch.simrank.meeting import topsim_dev

    results = []
    for s in samples:
        t0 = time.time()
        vals, idx = topsim_dev(
            g, TopSimConfig(sample=float(s), step=step, topk=topk, source_tile=source_tile),
            key=key, sources=sources, device=device,
        )
        approx = topk_to_dict(vals, idx, sources=sources)
        results.append(_score("topsim_dev", s, gold, approx, topk, time.time() - t0, log))
    return results
