"""Weighted-graph statistics, the ``DWGraph`` preprocessing (counterpart
of ``graphtpu/core/stats.py``).

``structures/DWGraph.java`` precomputes the in-edge probability
normalisation (``pre_deal :77-93``), each node's out-weight variance
(``deal_varience :96-112``) and an ``evidence`` factor (``:199``:
1 - 2^-min(d(u), d(v))).  Sums run over the CSR rows by segments
(``torch.segment_reduce`` with the degrees as lengths): no float atomics, so
runs on the card give the same bits.
"""

from __future__ import annotations

import torch

from graphtpu_torch.core.graph import Graph


def _row_sums(g: Graph, vals: torch.Tensor) -> torch.Tensor:
    """Sum of ``vals`` [E, ...] over each CSR row, in row order."""
    return torch.segment_reduce(vals, "sum", lengths=g.deg.long(), axis=0, unsafe=True)


def _weights(g: Graph) -> torch.Tensor:
    return g.weight if g.weight is not None else torch.ones_like(g.col, dtype=torch.float32)


def out_weight_sums(g: Graph) -> torch.Tensor:
    """float32[V]: the sum of each node's outgoing weights (pre_deal's
    denominator)."""
    return _row_sums(g, _weights(g))


def out_weight_variance(g: Graph) -> torch.Tensor:
    """float32[V]: the variance of each node's outgoing edge weights
    (deal_varience; 0 for degree-0 nodes), in two passes: the row means,
    then the squared deviations from them.  graphtpu's one pass,
    E[w^2] - E[w]^2, cancels: 3.7e-6 of the largest variance at the blog
    shape against 1e-7 here (ROADMAP C6)."""
    w = _weights(g)
    deg = g.deg.clamp(min=1).float()
    mean = _row_sums(g, w) / deg
    dev = w - torch.repeat_interleave(mean, g.deg.long(), output_size=w.shape[0])
    return torch.where(g.deg > 0, _row_sums(g, dev * dev) / deg, 0.0)


def evidence(g: Graph, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The evidence factor 1 - 2^-min(deg(u), deg(v)) (DWGraph.evidence)."""
    d = torch.minimum(g.deg[u.long()], g.deg[v.long()]).float()
    return 1.0 - torch.pow(2.0, -d)
