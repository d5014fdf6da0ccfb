"""Streaming CSR × dense products for exact SimRank (counterpart of
``graphtpu/kernels/spmm.py``).

SimRank's operator form S' = C·P·S·Pᵀ needs P·X with P the row-stochastic
adjacency: row i of P·X is ``Σ_u w(i,u)·X[u, :] / Σ_u w(i,u)``, a run of
gathered rows per output row.  The host builds one plan per graph, an
:class:`SpmvStream` of (slot, weight, output row) items sorted by output
row, and :func:`spmv` runs it:

* on a CUDA tensor, through the hand kernels of ``csrc/spmv.cu`` — B1
  (Kahan-compensated row sums, the gold mode) and B2 (plain f32 row sums,
  f32 or bf16 tables);
* on a CPU tensor, through :func:`spmv_plain`, the plain PyTorch version
  of both kernels.

Weighted P follows ``weighted/WeightedSimRank.java:68-93`` of the
reference; a degree-0 row is a zero row (``SimRank.java:69``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph

# kernel launches per mode, counted where the wrapper launches a kernel
SPMV_LAUNCHES = {"kahan": 0, "fast": 0}

# upper bound on the elements of spmv_plain's [T, C_blk] gather temporary
_PLAIN_TEMP_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class SpmvStream:
    """Flat row-major item stream.

    ``slots[t]``: first source row of X to read; ``wts[t*seg_k + j]``: the
    coefficient of row ``slots[t] + j`` with the output row's 1/Σw folded
    in; ``raw_wts``: the same without the fold; ``scales[t]``: the item's
    output-row 1/Σw; ``pos[t]``: output row, nondecreasing.  Isolated rows
    carry one (slot 0, weight 0) dummy item; items padding the stream to a
    ``block_items`` multiple run in the dummy output row V.
    ``row_items[r] .. row_items[r+1]`` are the items of output row r
    (int64[V+2]), which is how the CUDA kernels walk the stream.
    """

    slots: torch.Tensor     # int32[T]
    wts: torch.Tensor       # float32[T * seg_k]
    pos: torch.Tensor       # int32[T]
    raw_wts: torch.Tensor   # float32[T * seg_k]
    scales: torch.Tensor    # float32[T]
    row_items: torch.Tensor  # int64[V + 2]
    n_nodes: int
    n_items: int
    block_items: int
    uniform: bool           # all raw weights == 1 (fast mode skips the multiply)
    seg_k: int = 1          # table rows per item

    def to(self, device) -> "SpmvStream":
        move = {
            f: getattr(self, f).to(device)
            for f in ("slots", "wts", "pos", "raw_wts", "scales", "row_items")
        }
        return dataclasses.replace(self, **move)


def stream_from_numpy(
    slots, wts, pos, raw_wts, scales, n_nodes, n_items, block_items, uniform,
    seg_k=1, device="cpu",
) -> SpmvStream:
    """An :class:`SpmvStream` from host arrays (the fields of the JAX
    package's stream after ``np.asarray``), adding the per-row item offsets."""
    pos = np.asarray(pos, np.int32)
    row_items = np.searchsorted(pos, np.arange(n_nodes + 2)).astype(np.int64)

    def t(a, dt):
        return torch.tensor(np.asarray(a, dtype=dt), device=device)

    return SpmvStream(
        slots=t(slots, np.int32),
        wts=t(wts, np.float32),
        pos=t(pos, np.int32),
        raw_wts=t(raw_wts, np.float32),
        scales=t(scales, np.float32),
        row_items=t(row_items, np.int64),
        n_nodes=int(n_nodes),
        n_items=int(n_items),
        block_items=int(block_items),
        uniform=bool(uniform),
        seg_k=int(seg_k),
    )


def _row_scale(rp, wsrc, v):
    """float32[V]: 1/Σw per row, 0 for rows with no weight."""
    d = np.diff(rp)
    denom = np.zeros(v, np.float64)
    np.add.at(denom, np.repeat(np.arange(v), d), wsrc)
    return np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0)


def build_spmv_stream(
    g: Graph, weighted: bool = False, block_items: int = 1024, device=None
) -> SpmvStream:
    """One item per CSR slot, one dummy item per isolated row (numpy)."""
    rp_h, col_h, w_h, _ = g.host
    rp = rp_h.astype(np.int64)
    col = col_h.astype(np.int64)
    v = g.n_nodes
    d = np.diff(rp)
    wsrc = (
        np.asarray(w_h, np.float32)
        if (weighted and w_h is not None)
        else np.ones(len(col), np.float32)
    )
    scale = _row_scale(rp, wsrc, v)

    cnt = np.maximum(d, 1)
    t_real = int(cnt.sum())
    pos = np.repeat(np.arange(v), cnt).astype(np.int32)
    slots = np.zeros(t_real, np.int64)
    wts = np.zeros(t_real, np.float32)
    start = np.cumsum(cnt) - cnt
    e_idx = np.arange(t_real) - start[pos]
    real = e_idx < d[pos]
    slots[real] = col[rp[pos[real]] + e_idx[real]]
    wts[real] = (wsrc * scale.astype(np.float32)[np.repeat(np.arange(v), d)])[
        rp[pos[real]] + e_idx[real]
    ]
    raw = np.zeros(t_real, np.float32)
    raw[real] = wsrc[rp[pos[real]] + e_idx[real]]
    scales = scale.astype(np.float32)[pos]
    pad = (-t_real) % block_items
    if pad:
        # pad items run in the dummy row v (zero scale), so modes that skip
        # the per-item multiply stay uncontaminated
        slots = np.concatenate([slots, np.zeros(pad, np.int64)])
        wts = np.concatenate([wts, np.zeros(pad, np.float32)])
        raw = np.concatenate([raw, np.zeros(pad, np.float32)])
        scales = np.concatenate([scales, np.zeros(pad, np.float32)])
        pos = np.concatenate([pos, np.full(pad, v, np.int32)])
    uniform = bool(np.all(wsrc == 1.0))
    return stream_from_numpy(
        slots, wts, pos, raw, scales, v, t_real, block_items, uniform,
        device=device or g.device,
    )


def build_spmv_segments(
    g: Graph, weighted: bool = False, block_items: int = 1024, k: int = 2,
    device=None,
) -> SpmvStream:
    """Coalesced stream: maximal runs of consecutive neighbour ids are cut
    into ``k``-row segments, each one contiguous read of k table rows with
    per-row coefficients (0 for rows not in the run)."""
    if k < 1:
        raise ValueError(f"segment width must be >= 1, got {k}")
    if k == 1:
        return build_spmv_stream(
            g, weighted=weighted, block_items=block_items, device=device
        )
    rp_h, col_h, w_h, _ = g.host
    rp = rp_h.astype(np.int64)
    col = col_h.astype(np.int64)
    v = g.n_nodes
    d = np.diff(rp)
    e_total = int(rp[-1])
    wsrc = (
        np.asarray(w_h, np.float32)
        if (weighted and w_h is not None)
        else np.ones(e_total, np.float32)
    )
    row_of_e = np.repeat(np.arange(v), d)
    scale = _row_scale(rp, wsrc, v).astype(np.float32)
    order = np.lexsort((col, row_of_e))
    col = col[order]
    wsrc = wsrc[order]

    if e_total:
        prev_consec = np.zeros(e_total, bool)
        prev_consec[1:] = (col[1:] == col[:-1] + 1) & (
            row_of_e[1:] == row_of_e[:-1]
        )
        run_start = ~prev_consec
        run_id = np.cumsum(run_start) - 1
        run_first = np.flatnonzero(run_start)
        pos_in_run = np.arange(e_total) - run_first[run_id]
        seg_start = (pos_in_run % k) == 0
        seg_id = np.cumsum(seg_start) - 1
        seg_first_e = np.flatnonzero(seg_start)
        seg_slot = col[seg_first_e]
        seg_row = row_of_e[seg_first_e].astype(np.int64)
        # clamp so every k-row window stays inside the table; the
        # within-window offset shifts the weights accordingly
        start_c = np.minimum(seg_slot, max(v - k, 0))
        j_in = (col - start_c[seg_id]).astype(np.int64)
        assert j_in.max() < k
        n_seg = len(seg_first_e)
        w_fold = np.zeros((n_seg, k), np.float32)
        w_raw = np.zeros((n_seg, k), np.float32)
        w_fold[seg_id, j_in] = wsrc * scale[row_of_e]
        w_raw[seg_id, j_in] = wsrc
        seg_scales = scale[seg_row]
    else:
        start_c = np.zeros(0, np.int64)
        seg_row = np.zeros(0, np.int64)
        w_fold = np.zeros((0, k), np.float32)
        w_raw = np.zeros((0, k), np.float32)
        seg_scales = np.zeros(0, np.float32)

    iso = np.flatnonzero(d == 0)
    if len(iso):
        start_c = np.concatenate([start_c, np.zeros(len(iso), np.int64)])
        seg_row = np.concatenate([seg_row, iso])
        w_fold = np.concatenate([w_fold, np.zeros((len(iso), k), np.float32)])
        w_raw = np.concatenate([w_raw, np.zeros((len(iso), k), np.float32)])
        seg_scales = np.concatenate([seg_scales, np.zeros(len(iso), np.float32)])
        srt = np.argsort(seg_row, kind="stable")
        start_c, seg_row = start_c[srt], seg_row[srt]
        w_fold, w_raw, seg_scales = w_fold[srt], w_raw[srt], seg_scales[srt]
    t_real = len(seg_row)

    pad = (-t_real) % block_items
    if pad:
        start_c = np.concatenate([start_c, np.zeros(pad, np.int64)])
        seg_row = np.concatenate([seg_row, np.full(pad, v, np.int64)])
        w_fold = np.concatenate([w_fold, np.zeros((pad, k), np.float32)])
        w_raw = np.concatenate([w_raw, np.zeros((pad, k), np.float32)])
        seg_scales = np.concatenate([seg_scales, np.zeros(pad, np.float32)])
    return stream_from_numpy(
        start_c, w_fold.reshape(-1), seg_row.astype(np.int32),
        w_raw.reshape(-1), seg_scales, v, t_real, block_items,
        False,  # segment coefficients are masks: always multiply
        seg_k=k, device=device or g.device,
    )


def _first_item_scale(stream: SpmvStream) -> torch.Tensor:
    """float32[V+1]: each output row's scale, taken from its first item
    (0 for a row with no items)."""
    first = stream.row_items[:-1]
    has = stream.row_items[1:] > first
    s = stream.scales[first.clamp(max=stream.scales.numel() - 1)]
    return torch.where(has, s, torch.zeros_like(s))


def spmv_plain(
    stream: SpmvStream,
    table: torch.Tensor,
    mode: str = "kahan",
    table_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the raw [V+1, C] product.

    Gathers each item's table rows, applies ``where(col == row, 1,
    table_scale·x)`` when ``table_scale`` is given, multiplies by the folded
    ``wts`` (kahan) or the ``raw_wts`` (fast, skipped for uniform item
    streams) and ``index_add_``s by ``pos`` in f32; fast mode then scales
    each row by its first item's ``scales``.  Runs in column blocks so the
    [T, C_blk] gather temporary stays near 1 GB.  The result has the
    table's dtype.
    """
    _check_mode(mode, table)
    v, k = stream.n_nodes, stream.seg_k
    t_total = stream.slots.numel()
    n, c = table.shape
    dev = table.device
    slots = stream.slots.to(dev, torch.int64)
    pos = stream.pos.to(dev, torch.int64)
    w = (stream.wts if mode == "kahan" else stream.raw_wts).to(dev).view(t_total, k)
    multiply = mode == "kahan" or not (stream.uniform and k == 1)
    out = torch.empty((v + 1, c), dtype=table.dtype, device=dev)
    c_blk = max(1, min(c, _PLAIN_TEMP_ELEMS // max(t_total * k, 1)))
    row_scale = _first_item_scale(stream).to(dev)[:, None] if mode == "fast" else None
    for lo in range(0, c, c_blk):
        hi = min(c, lo + c_blk)
        xb = table[:, lo:hi].float()
        cols = torch.arange(lo, hi, device=dev)
        rows = None
        for j in range(k):
            r = xb[slots + j]
            if table_scale is not None:
                r = torch.where(
                    cols[None, :] == (slots + j)[:, None],
                    torch.ones_like(r), r * table_scale,
                )
            if multiply:
                r = r * w[:, j : j + 1]
            rows = r if rows is None else rows + r
        acc = torch.zeros((v + 1, hi - lo), dtype=torch.float32, device=dev)
        acc.index_add_(0, pos, rows)
        if row_scale is not None:
            acc = acc * row_scale
        out[:, lo:hi] = acc.to(table.dtype)
    return out


def _check_mode(mode: str, table: torch.Tensor) -> None:
    if mode not in SPMV_LAUNCHES:
        raise ValueError(f"unknown spmv mode {mode!r}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if mode == "kahan" and table.dtype != torch.float32:
        raise TypeError(
            "kahan mode is the exact-f32 path; bf16 tables use mode='fast'"
        )
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got shape {tuple(table.shape)}")


def spmv(
    stream: SpmvStream,
    table: torch.Tensor,
    mode: str = "kahan",
    table_scale: Optional[float] = None,
) -> torch.Tensor:
    """Raw P·table over ``stream``: [>=V, C] -> [V+1, C] (row V is the
    dummy row of the pad items; callers trim it).

    A CPU table runs :func:`spmv_plain`.  A CUDA table launches kernel B1
    (``mode="kahan"``) or B2 (``mode="fast"``) on the current stream, or
    raises; there is no other path.
    """
    _check_mode(mode, table)
    if table.device.type == "cpu":
        return spmv_plain(stream, table, mode, table_scale)
    if table.device.type != "cuda":
        raise RuntimeError(f"no spmv kernel for device {table.device}")
    return _spmv_cuda(stream, table, mode, table_scale)


def _spmv_cuda(stream, table, mode, table_scale):
    from graphtpu_torch.kernels import _build

    v, k = stream.n_nodes, stream.seg_k
    if k not in (1, 2, 4):
        raise ValueError(f"the CUDA kernels take seg_k in (1, 2, 4), got {k}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    n, c = table.shape
    if n < v:
        raise ValueError(f"table has {n} rows, the stream reads {v}")
    fields = (stream.slots, stream.wts, stream.raw_wts, stream.scales,
              stream.row_items)
    for f in fields:
        if f.device != table.device or not f.is_contiguous():
            raise ValueError("stream tensors must be contiguous on the table's device")
    out = torch.empty((v + 1, c), dtype=table.dtype, device=table.device)
    if c == 0:
        return out
    lib = _build.load()
    pin = table_scale is not None
    scale = ctypes.c_float(float(table_scale) if pin else 0.0)
    with torch.cuda.device(table.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if mode == "kahan":
            rc = lib.gt_spmv_kahan_f32(
                stream.slots.data_ptr(), stream.wts.data_ptr(),
                stream.row_items.data_ptr(), table.data_ptr(), out.data_ptr(),
                v + 1, c, k, int(pin), scale, cu_stream,
            )
        else:
            rc = lib.gt_spmv_fast(
                stream.slots.data_ptr(), stream.raw_wts.data_ptr(),
                stream.scales.data_ptr(), stream.row_items.data_ptr(),
                table.data_ptr(), out.data_ptr(), v + 1, c, k, int(pin), scale,
                int(not (stream.uniform and k == 1)),
                int(table.dtype == torch.bfloat16), cu_stream,
            )
    if rc != 0:
        raise RuntimeError(f"spmv {mode} kernel launch failed: {_build.error_string(rc)}")
    SPMV_LAUNCHES[mode] += 1
    return out


def spmm_oracle(
    g: Graph, x: np.ndarray, weighted: bool = False, rows=None
) -> np.ndarray:
    """numpy float64 P @ x for tests (a Python loop over rows); ``rows``
    limits it to those output rows, in that order."""
    rp, col, wh, _ = g.host
    rows = np.arange(g.n_nodes) if rows is None else np.asarray(rows)
    w = (
        np.asarray(wh, np.float64)
        if (weighted and wh is not None)
        else np.ones(len(col))
    )
    out = np.zeros((len(rows), x.shape[1]))
    for o, i in enumerate(rows):
        lo, hi = rp[i], rp[i + 1]
        if hi > lo:
            tot = w[lo:hi].sum()
            if tot > 0:
                xr = np.asarray(x[col[lo:hi]], np.float64)
                out[o] = (w[lo:hi, None] * xr).sum(0) / tot
    return out
