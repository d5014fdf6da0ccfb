"""Top-k precision and NDCG with ``utils/Eval.java`` semantics
(counterpart of ``graphtpu/eval/precision.py``).

* :func:`precision_sim_dicts`: score-aware precision (``Eval.java:81-140``).
  Per source, gold ids with sim >= MIN form set1 (the gold holds the top
  1,000), approx ids with sim >= MIN form set2, realK = min(TOPK, |set1|),
  precision = |set1 & set2| / realK (1.0 when realK is 0); the mean over
  sources.
* :func:`precision_at_k`: plain id-list overlap at k (``Eval.java:16-79``).
* :func:`ndcg_sim_dicts`: NDCG@k against exact scores
  (``Eval.java:257-291``): DCG = sum of 2^score_i * ln2 / ln(i+1) over
  1-based positions, ndcg = DCG(approx) / DCG(gold), averaged over sources.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from graphtpu_torch.core.config import MIN_SIM, TOPK

SimDict = Dict[int, List[Tuple[int, float]]]


def precision_at_k(
    gold_ids: Dict[int, List[int]],
    approx_ids: Dict[int, List[int]],
    k: int = TOPK,
) -> float:
    """Mean per-source |gold[:k] & approx[:k]| / k' (ids-only variant)."""
    total, s = 0, 0.0
    for src, gold in gold_ids.items():
        if src not in approx_ids:
            continue
        maxc = min(k, len(gold))
        if maxc == 0:
            continue
        s += len(set(gold[:maxc]) & set(approx_ids[src][:maxc])) / maxc
        total += 1
    return s / total if total else 0.0


def precision_sim_dicts(
    gold: SimDict, approx: SimDict, k: int = TOPK, min_sim: float = MIN_SIM
) -> float:
    total, s = 0, 0.0
    for src, gpairs in gold.items():
        set1 = {i for i, v in gpairs if v >= min_sim}
        set2 = {i for i, v in approx.get(src, []) if v >= min_sim}
        real_k = min(k, len(set1))
        s += 1.0 if real_k == 0 else len(set1 & set2) / real_k
        total += 1
    return s / total if total else 0.0


def _dcg(scores: Sequence[float]) -> float:
    # Eval.java:268-272: 1-based positions, discount ln2 / ln(i+1)
    return sum(
        (2.0 ** sc) * math.log(2) / math.log(i + 1)
        for i, sc in enumerate(scores, start=1)
    )


def ndcg_sim_dicts(gold: SimDict, approx: SimDict, k: int = TOPK) -> float:
    total, s = 0, 0.0
    for src, gpairs in gold.items():
        apairs = approx.get(src, [])
        n = min(len(gpairs), len(apairs), k)
        if n == 0:
            continue
        zk = _dcg([v for _, v in gpairs[:n]])
        if zk <= 0:
            continue
        s += _dcg([v for _, v in apairs[:n]]) / zk
        total += 1
    return s / total if total else 0.0
