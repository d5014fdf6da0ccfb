"""End-to-end pipelines (counterpart of ``graphtpu/pipelines.py``).

``node2vec_pipeline`` is ``node2vec/src/main.py:104-114``: read graph ->
simulate walks -> learn embeddings -> save ``.emb``.  Walks and SGNS run on
the device; the file is written on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from graphtpu_torch.core.config import SGNSConfig, WalkConfig
from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.io.embfile import write_emb
from graphtpu_torch.models.sgns import train_sgns
from graphtpu_torch.utils.metrics import StageClock
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
    ``stage_times``: if a dict, gets the ms of the stages "walks", "sgns"
    and "write" (``StageClock`` spans: the host clock, the device
    synchronised at each one's end), each a ``record_function`` range
    where the profiler records.
    """
    dev = resolve_device(device)
    clock = StageClock(stage_times, dev)
    with clock.span("walks"):
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
    with clock.span("sgns"):
        syn0, _ = train_sgns(walks, graph.n_nodes, sgns_cfg, key=key_for(seed, 1), device=dev)
    if output is not None:
        with clock.span("write"):
            ids = np.nonzero(graph.host[3] > 0)[0]
            labs = [str(i) for i in ids] if labels is None else [labels[i] for i in ids]
            write_emb(output, syn0[ids], labels=labs)
    return syn0
