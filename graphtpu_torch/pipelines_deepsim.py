"""The DeepSim pipeline, ``DeepSim/src/main.py`` as a function (counterpart
of ``graphtpu/pipelines_deepsim.py``).

Flow (``main.py:262-289``): read exact SimRank's ``.sim.txt`` top-k file,
load or draw node2vec walks with a ``walks.txt`` cache (``main.py:274-278``),
train the DeepSim autoencoder and return its embedding.  The walks and the
training run on the device; files are read and written on the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import DeepSimConfig, WalkConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.io.simfile import read_sim_file
from graphtpu_torch.models.deepsim import build_sim_table, train_deepsim
from graphtpu_torch.walks.walker import simulate_walks, walks_to_corpus


def read_simrank(path: str, min_sim: float = 1e-8) -> Dict[int, List[Tuple[int, float]]]:
    """Parse a .sim.txt and drop sims <= min_sim (``main.py:83-107``)."""
    return {src: [(i, v) for i, v in pairs if v > min_sim]
            for src, pairs in read_sim_file(path).items()}


def save_walks(path: str, walks) -> None:
    """The walks.txt cache: space-separated node ids per line, -1 padding
    dropped (``main.py:237-243``)."""
    with open(path, "w") as f:
        for row in walks_to_corpus(walks):
            f.write(" ".join(str(x) for x in row) + "\n")


def load_walks(path: str, walk_length: int) -> np.ndarray:
    """int32 [N, walk_length] from a walks.txt cache, short rows padded
    with -1."""
    rows = []
    with open(path) as f:
        for line in f:
            toks = [int(t) for t in line.split()]
            rows.append(toks[:walk_length] + [-1] * max(0, walk_length - len(toks)))
    return np.asarray(rows, np.int32)


def simrank_label_agreement(
    sim_dict: Dict[int, List[Tuple[int, float]]],
    labels: Sequence[Sequence[int]],
    topk: int = 10,
) -> float:
    """Diagnostic: the fraction of top-k sim pairs sharing >= 1 label
    (``preprocess_simrank``, ``main.py:132-167``)."""
    hits, total = 0, 0
    for src, pairs in sim_dict.items():
        if src >= len(labels) or not labels[src]:
            continue
        ls = set(labels[src])
        for dst, _ in pairs[:topk]:
            if dst >= len(labels):
                continue
            total += 1
            if ls & set(labels[dst]):
                hits += 1
    return hits / total if total else 0.0


def edge_label_homophily(g: Graph, labels: Sequence[Sequence[int]]) -> float:
    """Diagnostic: the fraction of edges whose endpoints share a label
    (``preprocess_edges``, ``main.py:169-191``)."""
    rp, col, _, _ = g.host
    hits, total = 0, 0
    for u in range(g.n_nodes):
        if u >= len(labels) or not labels[u]:
            continue
        lu = set(labels[u])
        for v in col[rp[u]: rp[u + 1]]:
            if v <= u or v >= len(labels):
                continue
            total += 1
            if lu & set(labels[v]):
                hits += 1
    return hits / total if total else 0.0


def deepsim_pipeline(
    g: Graph,
    simrank_path: str,
    cfg: DeepSimConfig = DeepSimConfig(),
    walk_cfg: WalkConfig = WalkConfig(),
    walks_cache: Optional[str] = None,
    seed: int = 0,
    steps: Optional[int] = None,
    device=None,
    stage_times: Optional[dict] = None,
) -> np.ndarray:
    """Returns float32 [V, dim] embeddings (= W1), computed on ``device``
    (default ``cuda``).  Walks are keyed by ``key_for(seed, 0)``, training
    by ``key_for(seed, 1)``.  ``stage_times``: if a dict, receives the host
    seconds of the stages "read" (the sim file and its table), "walks"
    (drawn or loaded) and "train", each ended by a device synchronise."""
    dev = resolve_device(device)
    marks = [time.perf_counter()]

    def mark():
        if stage_times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

    table = build_sim_table(read_simrank(simrank_path), g.n_nodes, device=dev)
    mark()
    if walks_cache and os.path.exists(walks_cache):
        walks = load_walks(walks_cache, walk_cfg.walk_length)
    else:
        walks = simulate_walks(
            g, num_walks=walk_cfg.num_walks, walk_length=walk_cfg.walk_length,
            key=key_for(seed, 0), p=walk_cfg.p, q=walk_cfg.q, device=dev,
        )
        if walks_cache:
            save_walks(walks_cache, walks)
    mark()
    emb = train_deepsim(walks, table, g.n_nodes, cfg, key=key_for(seed, 1), steps=steps,
                        device=dev)
    mark()
    if stage_times is not None:
        for name, a, b in zip(("read", "walks", "train"), marks, marks[1:]):
            stage_times[name] = b - a
    return emb
