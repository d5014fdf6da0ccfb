"""``.sim.txt`` top-k similarity files — exact reference format.

Writer semantics follow ``utils/Print.java``:
  * ``printByOrder`` / ``printByOrderAll`` emit TWO files per result
    (``Print.java:25-84``): a ``.txt`` with ids only
    (``v,n1,n2,...``) and a ``.sim.txt`` with scores
    (``v,n1:score1,n2:score2,...``), separator ``,`` and k/v separator ``:``
    (``conf/MyConfiguration.java:16-18``), scores ``%.6f`` (top-k) or
    ``%.7f`` (top-1000 "all" variant), sorted descending by score.
  * Lines end with CRLF in the reference; we write plain LF and accept both.

Readers accept both the "," separator and the older space-separated files
(e.g. ``IsoMap_LE/data/0_333_5038_simrank_navie_top10.txt.sim.txt:1``,
parsed by ``IsoMap_LE/simRank.py:76-93``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_sim_file(path: str) -> Dict[int, List[Tuple[int, float]]]:
    """Parse a ``.sim.txt`` file into {source: [(neighbor, score), ...]}.

    Order of neighbours is preserved (descending score as written).
    """
    out: Dict[int, List[Tuple[int, float]]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sep = "," if "," in line else None
            toks = line.split(sep) if sep else line.split()
            src = int(toks[0])
            pairs: List[Tuple[int, float]] = []
            for tok in toks[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":")
                pairs.append((int(k), float(v)))
            out[src] = pairs
    return out


def read_topk_ids(path: str) -> Dict[int, List[int]]:
    """Parse the ids-only ``.txt`` companion file (``v,n1,n2,...``)."""
    out: Dict[int, List[int]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sep = "," if "," in line else None
            toks = line.split(sep) if sep else line.split()
            out[int(toks[0])] = [int(t) for t in toks[1:]]
    return out


def write_sim_file(
    path: str,
    indices: np.ndarray,
    scores: np.ndarray,
    sources: Optional[np.ndarray] = None,
    precision: int = 6,
    separator: str = ",",
    kv_separator: str = ":",
    min_score: Optional[float] = None,
) -> None:
    """Write ``.sim.txt`` lines from dense [N, K] top-k (indices, scores).

    Entries with index < 0 are skipped (padding); ``min_score`` drops
    entries below a floor (callers usually pass None and pre-filter).
    """
    indices = np.asarray(indices)
    scores = np.asarray(scores)
    n = indices.shape[0]
    srcs = np.arange(n) if sources is None else np.asarray(sources)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for i in range(n):
            parts = [str(int(srcs[i]))]
            for j in range(indices.shape[1]):
                idx = int(indices[i, j])
                if idx < 0:
                    continue
                sc = float(scores[i, j])
                if min_score is not None and sc < min_score:
                    continue
                parts.append(f"{idx}{kv_separator}{sc:.{precision}f}")
            f.write(separator.join(parts) + "\n")


def write_topk_files(
    out_path: str,
    indices: np.ndarray,
    scores: np.ndarray,
    sources: Optional[np.ndarray] = None,
    precision: int = 6,
    separator: str = ",",
) -> Tuple[str, str]:
    """Reference `Print.printByOrder` twin output: ``out_path`` (ids only)
    plus ``out_path + ".sim.txt"`` (ids:scores).  Returns both paths."""
    indices = np.asarray(indices)
    scores = np.asarray(scores)
    n = indices.shape[0]
    srcs = np.arange(n) if sources is None else np.asarray(sources)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    sim_path = out_path + ".sim.txt"
    with open(out_path, "w") as fid, open(sim_path, "w") as fsim:
        for i in range(n):
            idparts = [str(int(srcs[i]))]
            simparts = [str(int(srcs[i]))]
            for j in range(indices.shape[1]):
                idx = int(indices[i, j])
                if idx < 0:
                    continue
                idparts.append(str(idx))
                simparts.append(f"{idx}:{float(scores[i, j]):.{precision}f}")
            fid.write(separator.join(idparts) + "\n")
            fsim.write(separator.join(simparts) + "\n")
    return out_path, sim_path
