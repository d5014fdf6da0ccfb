"""word2vec text ``.emb`` format (a copy of ``graphtpu/io/embfile.py``).

Header line ``<count> <dim>``, then one ``<label> <f1> ... <fdim>`` line per
node — the format gensim's ``save_word2vec_format`` writes and
``KeyedVectors.load_word2vec_format`` reads back
(``node2vec/src/main.py:98``, ``node2vec/src/classify.py:181``,
sample: ``node2vec/emb/karate.emb:1``).  Values are written ``%f`` (6dp) to
match the samples; labels may be arbitrary strings (node names).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def write_emb(
    path: str,
    embeddings: np.ndarray,
    labels: Optional[Sequence] = None,
    precision: int = 6,
) -> None:
    emb = np.asarray(embeddings)
    n, d = emb.shape
    if labels is None:
        labels = [str(i) for i in range(n)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{n} {d}\n")
        for lab, row in zip(labels, emb):
            vals = " ".join(f"{x:.{precision}f}" for x in row)
            f.write(f"{lab} {vals}\n")


def read_emb(path: str) -> Tuple[List[str], np.ndarray]:
    """Return (labels, float32[N, D]) preserving file order."""
    with open(path, "r") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        labels: List[str] = []
        vecs = np.empty((n, d), dtype=np.float32)
        for i in range(n):
            toks = f.readline().rstrip("\n").split(" ")
            labels.append(toks[0])
            vecs[i] = np.array(toks[1 : d + 1], dtype=np.float32)
    return labels, vecs


def read_emb_dict(path: str) -> Dict[str, np.ndarray]:
    labels, vecs = read_emb(path)
    return {lab: vecs[i] for i, lab in enumerate(labels)}
