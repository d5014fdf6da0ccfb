"""Least times on an NVIDIA H100 SXM, counted from the graph.

A frozen copy of the arithmetic of ``graphtpu_torch.bench.bounds``
(``bound``, ``spmv_work``), counted from what the benchmark builds itself
(V, the nonzeros of P, C = V columns, the configuration's precision) and
never from the program's item stream, so that a change of layout cannot
change the count.  Peaks: NVIDIA's data sheet for the H100 SXM at its
700 W limit, dense rates.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def bound_ms(nbytes: float, ops: float) -> float:
    """The larger of the bytes' time and the operations' time, in ms."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def spmv_work(nnz: int, v: int, c: int, itemsize: int, kahan: bool,
              pin: bool) -> Tuple[float, float]:
    """(bytes, operations) of one product P·X of an unweighted graph, X
    [V, C] in ``itemsize`` bytes, into a [V+1, C] result.  Bytes: X read
    once, the result written once, per nonzero its column and weight (and
    in the plain mode its scale), the row offsets.  Operations per nonzero
    and column: the pin's scale where it is fused, the weight multiply
    (compensated mode; the plain mode's uniform weights skip it) and the
    row sum, 4 operations of a Kahan update or 1 add."""
    nbytes = (v + v + 1) * c * itemsize + nnz * 4 * (2 + (0 if kahan else 1)) + (v + 2) * 8
    ops = nnz * (int(pin) + int(kahan) + (4 if kahan else 1))
    return float(nbytes), float(ops) * c


def products_ms(nnz: int, v: int, iterations: int, itemsize: int, kahan: bool) -> float:
    """Least ms of a solve's 2·iterations products at C = V: the first
    product of the first iteration reads the identity unpinned, every later
    first product has the pin fused, no second product has it."""
    unpinned = bound_ms(*spmv_work(nnz, v, v, itemsize, kahan, pin=False))
    pinned = bound_ms(*spmv_work(nnz, v, v, itemsize, kahan, pin=True))
    return (iterations + 1) * unpinned + (iterations - 1) * pinned


def iteration_ms(nnz: int, v: int) -> float:
    """Least ms of one SimRank iteration S' = C·P·S·Pᵀ, whatever computes
    it: 4·nnz·V float32 operations (two products, a multiply and an add per
    nonzero and column) against S read once and S' written once in
    float32."""
    return bound_ms(8.0 * v * v, 4.0 * nnz * v)
