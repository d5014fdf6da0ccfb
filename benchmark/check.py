"""The comparison that decides ``correct``: a program's top-k rows against
the float64 reference.

For each judged answer (per-row top-k ids and scores, however the program
delivered them) the numbers are:

* ``score_err``: the widest gap between a score the program gives and the
  reference's score at the same (row, id), over the row's scale;
* ``score_abs``: the same gap, not scaled (a written file rounds to 1e-6);
* ``rank_err``: the widest amount by which the reference's score at the
  r-th id the program gives lies below the reference's r-th best score of
  that row, over the row's scale.  Exact ties between structurally equal
  nodes cost nothing, whatever id the program picks among them;
* ``bad_rows``: rows whose ids are out of range or repeat, or that a file
  lacks or garbles.

A row's scale is the larger of its reference top-1 score and the median
top-1 score over all rows, so empty rows (isolated or pad nodes) are held
to the typical row's scale.  A number is held to its limit by
:func:`verdict`.
"""

from __future__ import annotations

import gc
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import simrank as reference


class Reference:
    """The reference's scores and per-row top-k, for judging answers."""

    def __init__(self, scores: torch.Tensor, k: int):
        self.s = scores
        self.top = torch.topk(scores, k, dim=1).values
        top1 = self.top[:, 0]
        self.scale = torch.clamp(top1, min=float(top1.median()))


def judge_topk(ref: Reference, vals: np.ndarray, idx: np.ndarray,
               bad_rows: int = 0) -> Dict[str, float]:
    """The numbers of one answer: [V, k] scores and ids."""
    dev = ref.s.device
    v, k = ref.top.shape
    ids = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev)
    got = torch.as_tensor(np.asarray(vals, np.float64), device=dev)
    if tuple(ids.shape) != (v, k) or tuple(got.shape) != (v, k):
        return {"score_err": float("inf"), "score_abs": float("inf"),
                "rank_err": float("inf"), "bad_rows": float(v)}
    in_range = ((ids >= 0) & (ids < v)).all(dim=1)
    srt = torch.sort(ids, dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(dim=1)
    ok = in_range & distinct
    at = torch.gather(ref.s, 1, ids.clamp(0, v - 1))
    scale = ref.scale[:, None]
    gap = (got - at).abs()
    below = (ref.top - at) / scale
    keep = ok[:, None]
    return {
        "score_err": float(torch.where(keep, gap / scale, 0).max()),
        "score_abs": float(torch.where(keep, gap, 0).max()),
        "rank_err": float(torch.where(keep, below, 0).max()),
        "bad_rows": float(bad_rows + int((~ok).sum())),
    }


def judge_simrank(edges: np.ndarray, n_nodes: int, c: float, iterations: int, topk: int,
                  device: torch.device, answers: Sequence[tuple]
                  ) -> Tuple[List[Dict[str, float]], torch.Tensor]:
    """([:func:`judge_topk`'s numbers of each answer (vals, idx, bad)], the
    reference's scores): the float64 SimRank of the edges after
    ``iterations``, solved once, with the allocator's cache emptied first."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    exact = reference.simrank(edges, n_nodes, c, iterations, device)
    ref = Reference(exact, topk)
    return [judge_topk(ref, vals, idx, bad) for vals, idx, bad in answers], exact


def worst(numbers: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over several answers."""
    out: Dict[str, float] = {}
    for n in numbers:
        for name, x in n.items():
            out[name] = max(out.get(name, -np.inf), x)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every limited number within its limit, {name: {value, limit}}).
    A number that is missing or not finite fails."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        x = numbers.get(name, float("nan"))
        good = bool(np.isfinite(x) and x <= limit)
        ok = ok and good
        rows[name] = {"value": x, "limit": limit}
    return ok, rows


def read_topk_files(ids_path: str, sim_path: str, v: int,
                    k: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(scores [V, k], ids [V, k], extra lines) from the two files a top-k
    job writes: ``ids_path`` lines ``i,n1,...,nk`` and ``sim_path`` lines
    ``i,n1:s1,...,nk:sk``, row i on line i.  A row that is missing, short,
    out of order, or whose two files disagree on its ids keeps the ids -1,
    which :func:`judge_topk` counts as bad."""
    vals = np.zeros((v, k), np.float64)
    idx = np.full((v, k), -1, np.int64)
    with open(ids_path) as f:
        id_lines = f.read().splitlines()
    with open(sim_path) as f:
        sim_lines = f.read().splitlines()
    extra = max(0, len(id_lines) - v) + max(0, len(sim_lines) - v)
    for i, (a, b) in enumerate(zip(id_lines[:v], sim_lines[:v])):
        ta = a.split(",")
        tb = b.split(",")
        try:
            pairs = [t.split(":") for t in tb[1:]]
            ids_a = [int(t) for t in ta[1:]]
            ids_b = [int(p[0]) for p in pairs]
            scores = [float(p[1]) for p in pairs]
            good = (int(ta[0]) == i and int(tb[0]) == i and len(ids_a) == k
                    and ids_a == ids_b)
        except (ValueError, IndexError):
            good = False
        if good:
            idx[i] = ids_b
            vals[i] = scores
    return vals, idx, extra
