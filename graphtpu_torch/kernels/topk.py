"""Top-k extraction and scatter-free accumulators (counterpart of
``graphtpu/kernels/topk.py``).

``lax.top_k`` puts the lower index first among equal scores, and SimRank
has many exact ties between structurally equal nodes; ``torch.topk``
promises no order.  So every top-k here is the first k of a stable
descending sort, which keeps equal scores in index order.  On a CUDA
tensor the hand kernel of ``csrc/topk.cu`` (``gt_topk_rows``: a bound
from one read of each row, then a selection among the few entries above
it; no sort of the row) gives those k, bit for bit, or the call raises; on any other device :func:`stable_topk_plain`
sorts the rows (``torch.sort``).

The Monte-Carlo engines accumulate item streams (target, value) into
per-source sums without a scatter: a stable sort brings each key's items
together, and each run's total is the difference of a float64 prefix sum
at the run's two ends.  graphtpu differences one float32 prefix over a
whole row, so its totals carry rounding at the scale of the row's mass;
here each total is rounded once to float32.  No float atomics, so a run
gives the same bits as the last.  :func:`segment_rows_sum` is SGNS's row
aggregation; :func:`bounded_topk_accumulate` is the reference's
capacity-bounded FixedCacheMap.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# rows per sort call of the plain version, sized so one call sorts at most
# ~2^27 elements
_SORT_ELEMS = 1 << 27
# kernel launches, counted where the wrapper launches its kernel
TOPK_LAUNCHES = {"topk": 0}
TOPK_DTYPES = (torch.float32, torch.bfloat16)
TOPK_MAX_K = 1024  # the kernel's most entries a row (its slots in shared memory)


def stable_topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the first k of each row of a stable descending
    ``torch.sort``, a chunk of rows a call; (values, int64 indices)."""
    b, v = x.shape
    rows = max(1, _SORT_ELEMS // max(v, 1))
    vals, idx = [], []
    for lo in range(0, b, rows):
        sv, si = torch.sort(x[lo : lo + rows], dim=1, descending=True, stable=True)
        vals.append(sv[:, :k])
        idx.append(si[:, :k])
    if not vals:
        return x.new_empty((0, k)), torch.empty((0, k), dtype=torch.int64, device=x.device)
    return torch.cat(vals), torch.cat(idx)


def check_topk_args(x: torch.Tensor, k: int, exclude_diag_offset: Optional[int] = None) -> None:
    """Raise on what the kernel does not take: anything but a contiguous
    2-D float32 or bfloat16 tensor, more than ``TOPK_MAX_K`` entries a row,
    or a masked diagonal that leaves the row.  Checks only: runs before any
    launch, on any device."""
    if x.dim() != 2:
        raise ValueError(f"the top-k kernel takes 2-D rows, got shape {tuple(x.shape)}")
    if x.dtype not in TOPK_DTYPES:
        raise TypeError(f"the top-k kernel takes float32 or bfloat16 rows, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the top-k kernel takes contiguous row-major rows")
    b, n = x.shape
    if k < 0 or min(k, n) > TOPK_MAX_K:
        raise ValueError(f"the top-k kernel keeps at most {TOPK_MAX_K} entries a row, "
                         f"asked for {k} of {n}")
    if exclude_diag_offset is not None and b > 0 and not (
            0 <= exclude_diag_offset and exclude_diag_offset + b <= n):
        raise ValueError(f"masked columns {exclude_diag_offset} .. "
                         f"{exclude_diag_offset + b - 1} leave rows of {n}")


def _topk_cuda(x: torch.Tensor, k: int, diag: Optional[int] = None):
    """The kernel on the current stream: (values, int64 indices) of the
    first min(k, N) of each row, column ``diag + i`` of row i read as -inf.
    The outputs are the one allocation."""
    from graphtpu_torch.kernels import _build

    check_topk_args(x, k, diag)
    b, n = x.shape
    kk = min(k, n)
    if b == 0:
        return x.new_empty((0, k)), torch.empty((0, k), dtype=torch.int64, device=x.device)
    vals = torch.empty((b, kk), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, kk), dtype=torch.int64, device=x.device)
    if kk == 0:
        return vals, idx
    lib = _build.load()
    with torch.cuda.device(x.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.gt_topk_rows(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, n, kk,
                              x.element_size(), -1 if diag is None else diag, cu_stream)
    if rc != 0:
        raise RuntimeError(f"top-k kernel launch failed: {_build.error_string(rc)}")
    TOPK_LAUNCHES["topk"] += 1
    return vals, idx


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices): the first k of each row under a stable
    descending sort; the kernel on a CUDA tensor, else the plain version."""
    if x.device.type == "cuda":
        return _topk_cuda(x, k)
    return stable_topk_plain(x, k)


def topk_rows(
    scores: torch.Tensor,
    k: int,
    exclude_diag_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest entries per row of [B, V],
    ties in index order.  ``exclude_diag_offset=r`` masks column ``r + i``
    in row i (on a CUDA tensor the kernel reads it as -inf; elsewhere a
    masked copy is sorted).  When k > V the result is padded with value 0,
    index -1."""
    k_eff = min(k, scores.shape[-1])
    if scores.device.type == "cuda":
        vals, idx = _topk_cuda(scores, k_eff, exclude_diag_offset)
    else:
        if exclude_diag_offset is not None:
            b = scores.shape[0]
            rows = torch.arange(b, device=scores.device)
            scores = scores.clone()
            scores[rows, exclude_diag_offset + rows] = float("-inf")
        vals, idx = stable_topk_plain(scores, k_eff)
    idx = idx.to(torch.int32)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return vals, idx


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor, vals_b: torch.Tensor,
    idx_b: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row top-k sets into one (streamed tile reduction)."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    mv, mi = _stable_topk(vals, k)
    return mv, torch.gather(idx, 1, mi)


def segment_rows_sum(
    idx: torch.Tensor, rows: torch.Tensor, n_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum [N, D] rows by segment id (counterpart of
    ``graphtpu/kernels/topk.py:207-251``): (sums [n_segments, D], float32
    counts [n_segments]); rows with idx < 0 are skipped.

    The same bits on every run: a stable sort by id puts each segment's rows
    together in their original order, and one sequential sum per segment
    and column (``torch.segment_reduce``) adds them in that order.  No
    float atomics, whose order changes from run to run (``index_add_`` on
    a CUDA tensor), so a resumed SGNS run reproduces an uninterrupted one.
    Skipped rows sort last, past the segments' total, and are never read
    (``unsafe``: the lengths may sum to less than N, with no device sync).
    The lengths are integer adds (``scatter_add_``, whose order cannot
    change a count), not ``bincount``, which reads the ids' range back to
    the host: no step of SGNS waits for the card, and a CUDA graph can
    hold it.
    """
    safe = torch.where(idx >= 0, idx, n_segments).long()
    order = torch.argsort(safe, stable=True)
    lengths = torch.zeros(n_segments + 1, dtype=torch.long, device=safe.device).scatter_add_(
        0, safe, torch.ones_like(safe))[:n_segments]
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0, unsafe=True)
    return sums, lengths.float()


def _run_totals(keys: torch.Tensor, vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_end, float64 total) along the last dim of ``keys``, sorted there:
    ``is_end`` marks the last item of each run of equal keys, where
    ``total`` is that run's sum of ``vals``: the float64 prefix at the item
    less the prefix before its run's start, which a binary search of the
    sorted keys finds.  (A cummax carrying each start forward, as graphtpu
    does, is one serial scan of a 1-D row on a CUDA device: 76 ms for
    25.6 M items on an H100.)"""
    csum = torch.cumsum(vals.double(), dim=-1)
    before = torch.nn.functional.pad(csum, (1, 0))  # the prefix before each position
    start = torch.searchsorted(keys, keys)
    is_end = torch.ones_like(keys, dtype=torch.bool)
    is_end[..., :-1] = keys[..., :-1] != keys[..., 1:]
    return is_end, csum - before.gather(-1, start)


def segment_topk(
    targets: torch.Tensor, values: torch.Tensor, k: int, n_classes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of per-target sums from an item stream, scatter-free
    (counterpart of ``graphtpu/kernels/topk.py:63-113``).

    ``targets``/``values``: [T, N] items per source (target < 0 = skip).
    Returns (vals [T, k] descending, int32 idx [T, k], -1 padded); equal
    sums come in target order."""
    t, n = targets.shape
    tt = torch.where(targets >= 0, targets, n_classes).int()
    st, order = torch.sort(tt, dim=1, stable=True)
    is_end, total = _run_totals(st, values.float().gather(1, order))
    cand = torch.where(is_end & (st < n_classes), total.float(), float("-inf"))
    k_eff = min(k, n)
    vals, pos = _stable_topk(cand, k_eff)
    idx = st.gather(1, pos)
    ok = torch.isfinite(vals)
    vals = torch.where(ok, vals, 0.0).to(values.dtype)
    idx = torch.where(ok, idx, -1)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
    return vals, idx


def segment_sum_1d(ids: torch.Tensor, vals: torch.Tensor, n_segments: int) -> torch.Tensor:
    """[n_segments] sums of ``vals`` grouped by ``ids`` (< 0 skipped), with
    no scatter: a sort, a float64 prefix sum and two searchsorted lookups
    per segment (counterpart of ``graphtpu/kernels/topk.py:116-137``)."""
    safe = torch.where(ids >= 0, ids, n_segments).long()
    si, order = torch.sort(safe, stable=True)
    csum = torch.cumsum(vals.double()[order], 0)
    csum = torch.cat([csum.new_zeros(1), csum])
    seg = torch.arange(n_segments, device=ids.device)
    right = torch.searchsorted(si, seg, right=True)
    left = torch.searchsorted(si, seg)
    return (csum[right] - csum[left]).to(vals.dtype)


_BIG = 2**31 - 1


def pair_topk_by_source(
    srcs: torch.Tensor,
    tgts: torch.Tensor,
    vals: torch.Tensor,
    source_ids: torch.Tensor,
    k: int,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-source top-k of per-(src, tgt) sums from a flat item stream
    (counterpart of ``graphtpu/kernels/topk.py:140-204``).

    ``srcs``/``tgts``/``vals``: [N] items (src or tgt < 0 = skip).
    ``source_ids``: [M] ascending source ids to emit rows for.
    ``counts``: optional per-source normaliser of the summed values (the
    Giraph flush normalisation).  Returns (float32 vals [M, k] descending,
    int32 idx [M, k], -1 padded); equal totals come in target order.

    1. one sort by (src, tgt), packed into one int64 key;
    2. each pair's total from a float64 prefix sum;
    3. the totals ordered by (src, -total, tgt): stably by -total, then
       stably by src, from (src, tgt) order;
    4. each source's first k entries by searchsorted and gathers.
    """
    n = srcs.shape[0]
    valid = (srcs >= 0) & (tgts >= 0)
    s_c = torch.where(valid, srcs, _BIG).long()
    t_c = torch.where(valid, tgts, _BIG).long()
    key, order = torch.sort((s_c << 32) | t_c, stable=True)
    s1, t1 = key >> 32, key & 0xFFFFFFFF
    is_end, total = _run_totals(key, vals.float()[order])
    if counts is not None:
        norm = counts.double()[s1.clamp(max=counts.shape[0] - 1)]
        total = total / norm.clamp(min=1.0)
    live = is_end & (s1 != _BIG)
    neg = torch.where(live, -total.float(), float("inf"))
    by_val = torch.sort(neg, stable=True).indices
    s_live = torch.where(live, s1, _BIG)[by_val]
    by_src = torch.sort(s_live, stable=True).indices
    perm = by_val[by_src]
    s2, v2, t2 = s_live[by_src], -neg[perm], t1[perm]
    sid = source_ids.to(device=srcs.device, dtype=torch.int64)
    left = torch.searchsorted(s2, sid)
    take = (left[:, None] + torch.arange(k, device=srcs.device)).clamp(max=max(n - 1, 0))
    ok = (s2[take] == sid[:, None]) & torch.isfinite(v2[take])
    out_vals = torch.where(ok, v2[take], 0.0)
    out_idx = torch.where(ok, t2[take], -1).int()
    return out_vals, out_idx


def segment_rows_sum_matmul(
    idx: torch.Tensor,
    rows: torch.Tensor,
    n_segments: int,
    chunk: int = 8192,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment row sums as chunked one-hot products (counterpart of
    ``graphtpu/kernels/topk.py:254-292``): (sums [n_segments, D], float32
    counts [n_segments]); idx outside [0, n_segments) is skipped.

    Each chunk's one-hot [C, S] and rows are rounded to ``compute_dtype``
    (the one-hot exactly), then multiplied in full float32, as graphtpu's
    products with float32 results; counts come from a ones column."""
    from graphtpu_torch.core.device import full_fp32

    n, d = rows.shape
    dev = rows.device
    seg_ids = torch.arange(n_segments, device=dev)
    rows_aug = torch.cat(
        [rows.to(compute_dtype), torch.ones((n, 1), dtype=compute_dtype, device=dev)], dim=1
    ).float()
    acc = torch.zeros((n_segments, d + 1), dtype=torch.float32, device=dev)
    with full_fp32():
        for lo in range(0, n, chunk):
            ci = idx[lo : lo + chunk]
            onehot = (ci[:, None] == seg_ids[None, :]).to(compute_dtype).float()
            acc = acc + onehot.T @ rows_aug[lo : lo + chunk]
    return acc[:, :d].to(rows.dtype), acc[:, d]


def bounded_topk_accumulate(
    keys: torch.Tensor,
    values: torch.Tensor,
    capacity: int,
    init_keys: Optional[torch.Tensor] = None,
    init_values: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FixedCacheMap.put semantics over an item stream, per source
    (counterpart of ``graphtpu/kernels/topk.py:295-350``).

    ``keys``/``values``: [B, N] item streams (key < 0 = skip).  Returns
    (int32 slot_keys [B, C], slot_values [B, C]), -1 in empty key slots.
    Items are taken in order (``FixedCacheMap.java:32-50``): a present key
    accumulates; a new key fills the first empty slot; once full, a new key
    evicts the current minimum only if its value is strictly greater."""
    b, n = keys.shape
    dev = keys.device
    if init_keys is None:
        sk = torch.full((b, capacity), -1, dtype=torch.int32, device=dev)
        sv = torch.zeros((b, capacity), dtype=values.dtype, device=dev)
    else:
        sk, sv = init_keys.clone().int(), init_values.clone()
    rows = torch.arange(b, device=dev)
    for j in range(n):
        k_i, v_i = keys[:, j].int(), values[:, j]
        valid = k_i >= 0
        match = sk == k_i[:, None]
        present = match.any(dim=1)
        sv = sv + torch.where(match & valid[:, None], v_i[:, None], 0)
        empty = sk < 0
        has_empty = empty.any(dim=1)
        first_empty = empty.int().argmax(dim=1)
        do_insert = valid & ~present & has_empty
        sk[rows, first_empty] = torch.where(do_insert, k_i, sk[rows, first_empty])
        sv[rows, first_empty] = torch.where(do_insert, v_i, sv[rows, first_empty])
        occupied_v = torch.where(sk >= 0, sv, float("inf"))
        minpos = occupied_v.argmin(dim=1)
        do_evict = valid & ~present & ~has_empty & (v_i > occupied_v[rows, minpos])
        sk[rows, minpos] = torch.where(do_evict, k_i, sk[rows, minpos])
        sv[rows, minpos] = torch.where(do_evict, v_i, sv[rows, minpos])
    return sk, sv


def bounded_slots_to_topk(
    slot_k: torch.Tensor, slot_v: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k (values, keys) from accumulator slots, ties in slot
    order."""
    masked = torch.where(slot_k >= 0, slot_v, float("-inf"))
    vals, pos = _stable_topk(masked, k)
    keys = slot_k.gather(1, pos)
    ok = torch.isfinite(vals)
    return torch.where(ok, vals, 0.0), torch.where(ok, keys, -1)
