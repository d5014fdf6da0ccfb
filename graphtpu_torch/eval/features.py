"""Path and label feature emitters, the ``sjstools`` tools (counterpart of
``graphtpu/eval/features.py``).

``sjstools/ProducePaths.java`` dumps sampled walk paths as ML features;
``ProduceLabels.java`` emits per-pair labels comparing single- vs
double-walk scores; ``GetMaxPrecision.java:32-60`` picks the best
precision across strategies.  These feed downstream learned rankers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def produce_paths(walks: np.ndarray, out_path: str) -> int:
    """Write sampled walk paths, one space-separated line each
    (ProducePaths output shape).  Returns lines written."""
    n = 0
    with open(out_path, "w") as f:
        for row in np.asarray(walks):
            stop = np.argmax(row < 0) if (row < 0).any() else len(row)
            if stop == 0:
                continue
            f.write(" ".join(str(int(x)) for x in row[:stop]) + "\n")
            n += 1
    return n


def produce_labels(
    single: Dict[int, List[Tuple[int, float]]],
    double: Dict[int, List[Tuple[int, float]]],
    gold: Dict[int, List[Tuple[int, float]]],
    topk: int = 20,
) -> List[Tuple[int, int, int]]:
    """(src, dst, label) rows: label 1 when the single-walk strategy ranks
    the pair inside gold top-k and the double-walk one does not, -1 for
    the converse, 0 otherwise (the ProduceLabels single-vs-double signal).
    """
    out = []
    for src, gpairs in gold.items():
        gset = {i for i, _ in gpairs[:topk]}
        sset = {i for i, _ in single.get(src, [])[:topk]}
        dset = {i for i, _ in double.get(src, [])[:topk]}
        for dst in gset:
            s_hit, d_hit = dst in sset, dst in dset
            label = 1 if (s_hit and not d_hit) else (-1 if (d_hit and not s_hit) else 0)
            out.append((src, dst, label))
    return out


def max_precision(
    per_strategy: Dict[str, float]
) -> Tuple[str, float]:
    """Best (strategy, precision) — GetMaxPrecision.java:32-60."""
    best = max(per_strategy.items(), key=lambda kv: kv[1])
    return best
