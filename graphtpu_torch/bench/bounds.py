"""Least times of the port's kernels on an NVIDIA H100 SXM.

A kernel's bound is the larger of its bytes over the card's memory rate
and its operations over the card's peak rate for their type: each input
read once, each output written once, and only the operations these
inputs need (real items, not padding).  The peaks are NVIDIA's published
figures for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmv_work(n_items: int, seg_k: int, v: int, c: int, itemsize: int, mode: str,
              pin: bool, multiply: bool, n_terms: int = None) -> Tuple[float, float]:
    """(bytes, operations) of one B1/B2 product over an item stream.

    Bytes: the table's V rows, the [V+1, C] output, and per item its slot
    and seg_k weights (B2 also its scale), plus the row offsets.  Per
    column: for each of the ``n_terms`` sub-rows with a nonzero coefficient
    (default: every item's seg_k; :func:`stream_terms`) the pin's scale
    (when fused) and the weight multiply (B1 always, B2 where ``multiply``),
    the adds joining an item's terms (n_terms - n_items), and per item the
    row sum: 4 operations of a Kahan update (B1) or 1 add (B2)."""
    kahan = mode == "kahan"
    n_terms = n_items * seg_k if n_terms is None else n_terms
    nbytes = (v + v + 1) * c * itemsize + n_items * 4 * (1 + seg_k + (0 if kahan else 1))
    nbytes += (v + 2) * 8
    ops = (n_terms * (int(pin) + int(kahan or multiply)) + (n_terms - n_items)
           + n_items * (4 if kahan else 1))
    return float(nbytes), float(ops) * c


def transpose_work(rows: int, cols: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one transpose of a [rows, cols] tensor into a
    new one: each element read once and written once, no arithmetic."""
    return float(2 * rows * cols * itemsize), 0.0


def topk_work(rows: int, n: int, k: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one row top-k: the [rows, n] input read once,
    the [rows, k] values and int64 indices written once, no arithmetic
    counted."""
    return float(rows * n * itemsize + rows * k * (itemsize + 8)), 0.0


def expand_work(rows: int, w: int, length: int) -> Tuple[float, float]:
    """(bytes, operations) of one TopSim expansion (TS1) of ``rows``
    frontiers of ``w`` slots of ``length``-node paths: the child paths and
    masses written, the parents' masses, the draws and the parents' nodes
    read (one int32 a slot: the node at the depth, not the whole path); no
    operation counted (a few integer ones a slot)."""
    return float(rows * w * (4 * length + 4 + 4 + 4 + 4)), 0.0


def sgns_step_work(v: int, d: int, b: int, w2: int, n: int, live: int) -> Tuple[float, float]:
    """(bytes, operations) of one SGNS step's gradients (SG1) over [V, D]
    float32 tables, a batch of ``b`` centers with ``w2`` context slots and
    ``n`` shared negatives, ``live`` of its slots with a coefficient.
    Bytes as ``benchmark/roofline_node2vec.py`` counts a step's: both
    tables read and two tables written once (the rows it looks up are
    re-reads, from L2 at the cell's V), the batch's int32 ids and bool mask
    read once.  Operations: a live slot's dot product, its term of dv and
    its term of a syn1 row (6 D), a center's dv added into its row (D)."""
    nbytes = 4 * v * d * 4 + b * (4 + w2 * (4 + 1)) + b * n * 4
    return float(nbytes), float(6 * d * live + d * b)


def stream_terms(stream) -> int:
    """The terms of an item stream: its items (seg-1), or its real items'
    sub-rows with a nonzero raw coefficient (seg-k)."""
    if stream.seg_k == 1:
        return stream.n_items
    return int((stream.raw_wts[: stream.n_items * stream.seg_k] != 0).sum().item())


def stream_work(stream, c: int, itemsize: int, mode: str, pin: bool) -> Tuple[float, float]:
    """:func:`spmv_work` of ``stream`` at ``c`` columns: B2 multiplies
    only where a raw coefficient may differ from 1 (neither a uniform seg-1
    nor a mask-uniform seg-k stream)."""
    masks = stream.uniform if stream.seg_k == 1 else stream.mask_uniform
    return spmv_work(stream.n_items, stream.seg_k, stream.n_nodes, c, itemsize, mode, pin,
                     multiply=mode == "kahan" or not masks, n_terms=stream_terms(stream))


def gather_work(m: int, w: int, c: int, table_rows: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one B3 level: [M, W] slots and weights over a
    [table_rows, C] table into [M, C] f32; a multiply and an add per slot
    and column."""
    nbytes = table_rows * c * itemsize + m * c * 4 + m * w * 8
    return float(nbytes), 2.0 * m * w * c


def rate_work(kernel: str, n_items: int, v: int, c: int, n_buf: int) -> Tuple[float, float]:
    """(bytes, operations) of a rate-probe kernel over an item stream into
    [V+1, C] f32: X1 reads the table and takes a max per item and column;
    X2 reads a resident [n_buf, C] buffer and the weights, a multiply and
    an add per item and column; X3 reads the table and adds."""
    out = (v + 1) * c * 4 + (v + 2) * 8
    if kernel == "accumulate_only":
        return float(n_buf * c * 4 + n_items * 4 + out), 2.0 * n_items * c
    return float(v * c * 4 + n_items * 4 + out), float(n_items) * c
