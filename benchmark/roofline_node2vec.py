"""Least time of the SGNS steps of a node2vec job on an NVIDIA H100 SXM,
counted from what the steps must read and write.

A step (``graphtpu_torch.models.sgns.sgns_step``) reads both tables and
writes both anew, [V, D] float32 each, and reads its batch: B int32
centers, B·2w int32 contexts and their bool mask, B·N int32 negatives.
Each of those bytes is counted once, whatever the step reads again: the
rows it looks up are re-reads of the tables, which at V = 16,384 (16.8 MB)
stay in the card's 50 MB L2.  Bytes at ``benchmark.roofline``'s HBM peak.
"""

from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S


def steps_bytes(steps: float, centers: float, negatives: float, n_nodes: int, dim: int,
                window: int, itemsize: int = 4) -> float:
    """Bytes of ``steps`` steps that drew ``centers`` center slots and
    ``negatives`` negatives in all."""
    tables = steps * 4 * n_nodes * dim * itemsize  # two tables read, two written
    batch = centers * (4 + 2 * window * (4 + 1)) + negatives * 4
    return tables + batch


def steps_ms(steps: float, centers: float, negatives: float, n_nodes: int, dim: int,
             window: int) -> float:
    return 1e3 * steps_bytes(steps, centers, negatives, n_nodes, dim, window) / HBM_BYTES_PER_S
