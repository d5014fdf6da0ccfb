"""End-to-end pipelines (counterpart of ``graphtpu/pipelines.py``).

``node2vec_pipeline`` is ``node2vec/src/main.py:104-114``: read graph ->
simulate walks -> learn embeddings -> save ``.emb``.  Walks and SGNS run on
the device; the file is written on the host.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from graphtpu_torch.core.config import SGNSConfig, WalkConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.io.embfile import write_emb
from graphtpu_torch.models.sgns import train_sgns
from graphtpu_torch.walks.walker import simulate_walks


def node2vec_pipeline(
    graph: Graph,
    walk_cfg: WalkConfig = WalkConfig(),
    sgns_cfg: SGNSConfig = SGNSConfig(),
    seed: int = 0,
    output: Optional[str] = None,
    labels: Optional[Sequence] = None,
    device=None,
    stage_times: Optional[dict] = None,
) -> np.ndarray:
    """Returns float32 [V, dim] embeddings (rows of isolated nodes keep
    their initial values), computed on ``device`` (default ``cuda``).

    ``labels``: node names for the ``.emb`` file; default str(node id).
    The reference writes the nodes seen in walks; this writes every
    non-isolated node (the same set on a connected graph).
    ``stage_times``: if a dict, receives the host seconds of the stages
    "walks", "sgns" and "write", each ended by a device synchronise.
    """
    dev = resolve_device(device)
    marks = [time.perf_counter()]

    def mark():
        if stage_times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

    walks = simulate_walks(
        graph,
        num_walks=walk_cfg.num_walks,
        walk_length=walk_cfg.walk_length,
        key=key_for(seed, 0),
        p=walk_cfg.p,
        q=walk_cfg.q,
        weighted=graph.is_weighted,
        second_order_mode=walk_cfg.second_order_mode,
        max_trials=walk_cfg.max_rejection_trials,
        device=dev,
    )
    mark()
    syn0, _ = train_sgns(walks, graph.n_nodes, sgns_cfg, key=key_for(seed, 1), device=dev)
    mark()
    if output is not None:
        ids = np.nonzero(graph.host[3] > 0)[0]
        labs = [str(i) for i in ids] if labels is None else [labels[i] for i in ids]
        write_emb(output, syn0[ids], labels=labs)
    mark()
    if stage_times is not None:
        for name, a, b in zip(("walks", "sgns", "write"), marks, marks[1:]):
            stage_times[name] = b - a
    return syn0
