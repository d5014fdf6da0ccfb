"""CSR × dense products for exact SimRank (counterpart of
``graphtpu/kernels/spmm.py``).

SimRank's operator form S' = C·P·S·Pᵀ needs P·X with P the row-stochastic
adjacency: row i of P·X is ``Σ_u w(i,u)·X[u, :] / Σ_u w(i,u)``, a run of
gathered rows per output row.  The host builds one plan per graph, in one
of two forms:

* an :class:`SpmvStream` of (slot, weight, output row) items sorted by
  output row, on the card with the ``layout`` its :func:`design_rule`
  gives it (:func:`with_layout` sets another), run by :func:`spmv`
  — on a CUDA tensor through the hand kernels of ``csrc/spmv.cu``, B1
  (Kahan-compensated row sums, the gold mode) and B2 (plain f32 row sums,
  f32 or bf16 tables); on a CPU tensor through :func:`spmv_plain`, the
  plain PyTorch version of both;
* a :class:`ReductionTree`, a padded W-ary gather-reduction tree run by
  :func:`tree_spmm` one level at a time — on a CUDA tensor through the
  hand kernel B3 of ``csrc/gather.cu`` (as the column panel over the
  level's compact plan, :class:`GatherLayout`, where it fits), on a CPU
  tensor through :func:`gather_rows_sum_plain`; :func:`gather_rows_sum`
  runs one level.

Weighted P follows ``weighted/WeightedSimRank.java:68-93`` of the
reference; a degree-0 row is a zero row (``SimRank.java:69``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph

# kernel launches, counted where a wrapper launches its kernel
SPMV_LAUNCHES = {"kahan": 0, "fast": 0}
GATHER_LAUNCHES = {"gather_rows_sum": 0}

# upper bound on the elements of spmv_plain's [T, C_blk] gather temporary
_PLAIN_TEMP_ELEMS = 1 << 28


# The sliced layout of the CUDA kernels B1/B2 (csrc/spmv.cu).  A block runs
# SELL_WARPS consumer warps; a chunk of the layout gives each warp 32 lanes
# x SELL_JB item positions of 16-bit slots and is what one ring stage holds.
SELL_WARPS = 16
SELL_JB = 16
SELL_CHUNK = SELL_WARPS * 32 * SELL_JB  # positions per chunk: 16 KB of slots
SELL_STAGES = 3
SELL_HUB = 128          # rows with more items are hub rows (warp per row)
SELL_SIGMA = 4096       # rows sorted by item count within windows of this many
SMEM_BYTES = 232_448    # dynamic shared memory one block may use on sm_90
SELL_BARRIER_BYTES = 128


def sell_fits(v: int) -> bool:
    """Whether a 16-byte slab of ``v`` table rows fits one block's shared
    memory beside the ring of slot chunks (V <= 11,448)."""
    room = SMEM_BYTES - SELL_BARRIER_BYTES - SELL_STAGES * SELL_CHUNK * 2
    return v * 16 <= room


def panel_stream(stream: "SpmvStream") -> bool:
    """Whether the column panel's sliced layout takes ``stream``'s
    coefficients: a uniform seg-1 stream, or a seg-2 or seg-4 stream that
    is :attr:`SpmvStream.mask_uniform`."""
    if stream.seg_k == 1:
        return stream.uniform
    return stream.seg_k in (2, 4) and stream.mask_uniform


def runs_panel(stream: "SpmvStream") -> bool:
    """Whether B1/B2 run ``stream`` as the column panel over every table
    row on the card: a :func:`panel_stream` of 1 <= V rows that fit
    :func:`sell_fits`."""
    return panel_stream(stream) and stream.n_nodes >= 1 and sell_fits(stream.n_nodes)


def spmv_design(stream: "SpmvStream", dtype=torch.float32) -> str:
    """The design B1/B2 run ``stream`` in on the card over a ``dtype``
    table, from the type of its ``layout``: "panel" (the column panel over
    a :class:`SellLayout`), "packed" (the packed-lane panel over a
    :class:`PackedLayout`), "tiles" (the L2 column tiles over a
    :class:`TilePlan`, f32 tables only) or "rows" (row tiles).  A stream
    built on the card gets the layout of its :func:`design_rule`;
    :func:`with_layout` sets another, :func:`row_tiles` none."""
    design = _DESIGNS[type(stream.layout)][0] if stream.layout is not None else "rows"
    return "rows" if design == "tiles" and dtype != torch.float32 else design


# A slot entry of the sliced layout: the table row in bits 0-13 (V <=
# 11,448 < 2^14) and, in a seg-k layout, SELL_END where the position ends
# its segment.
SELL_END = 0x8000
SELL_ROW = 0x3FFF


class _Tensors:
    """``to`` for a frozen dataclass of tensors and plain values."""

    def to(self, device):
        return dataclasses.replace(self, **{
            n: t.to(device) for n, t in _tensor_fields(self).items()})


def _tensor_fields(obj) -> dict:
    """The tensor fields of dataclass ``obj``, by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


@dataclasses.dataclass(frozen=True)
class SellLayout(_Tensors):
    """A :func:`panel_stream` in the sliced order kernels B1/B2 walk as the
    column panel (SELL-32-σ).

    The walk's *positions* are the stream's table rows in stream order:
    every item of a seg-1 stream; of a seg-k stream, the sub-rows (item t,
    then j) whose coefficient is nonzero, row ``slots[t] + j``.  A
    segment's last position ends it: every position of a seg-1 stream.

    Output rows with at most ``SELL_HUB`` positions are lane rows: sorted
    by position count within windows of ``SELL_SIGMA`` rows and dealt 32
    to a *unit*, lane l walking its own row's positions in stream order.
    Longer rows are hub rows, cut into *pieces* of up to 32·``SELL_HUB``
    positions; a piece is a unit whose lane l takes positions l, l+32, ...
    of the piece.  Units are grouped ``SELL_WARPS`` to a super-slice (hub
    pieces first, longest first, then the lane units in order); super-slice
    s spans ``ss_chunks[s]`` chunks, the j-blocks b = 0, 1, ... of its
    positions: in chunk c, entry ``c·SELL_CHUNK + (w·SELL_JB + jj)·32 + l``
    is position ``SELL_JB·b + jj`` of lane l of unit ``s·SELL_WARPS + w``.

    ``slots[p]`` is entry p: the position's table row (``SELL_ROW`` bits)
    and, in a seg-k layout, ``SELL_END`` where it ends its segment and on
    every position of a hub piece, whose lanes split segments (a seg-1
    layout's entries are bare rows, each position its own segment; pads:
    0).
    ``item[p]`` is the position's coefficient index t·k + j (the item t of
    a seg-1 stream; -1 for a pad).  ``lane_row``/``lane_cnt`` give each
    lane its output row (-1 none) and position count, ``lane_base`` the
    index of its first position in stream order (0 for a lane with none;
    for a seg-1 stream the stream index of its first item): position j of
    a lane is ``lane_base + j`` (lane rows) or ``lane_base + 32·j`` (hub
    pieces).  ``unit_hub[u]`` is a hub unit's piece index, -1 for lane
    rows.  Hub row ``hub_rows[h]`` sums pieces ``hub_piece[h] ..
    hub_piece[h+1]`` in that order.  ``row_wts[r]`` is row r's first
    nonzero folded coefficient (B1) and ``row_scale[r]`` its first item's
    scale (B2), 0 for a row with no positions; every position of a row has
    them.  ``host_ms``: host time of the build.
    """

    slots: torch.Tensor      # int16[NC * SELL_CHUNK], read as uint16
    item: torch.Tensor       # int32[NC * SELL_CHUNK]
    lane_row: torch.Tensor   # int32[NU * 32]
    lane_cnt: torch.Tensor   # int32[NU * 32]
    lane_base: torch.Tensor  # int32[NU * 32]
    unit_hub: torch.Tensor   # int32[NU]
    ss_chunks: torch.Tensor  # int32[NSS]
    hub_rows: torch.Tensor   # int32[NH]
    hub_piece: torch.Tensor  # int32[NH + 1]
    row_scale: torch.Tensor  # float32[V + 1]
    row_wts: torch.Tensor    # float32[V + 1]
    n_chunks: int
    n_pieces: int
    host_ms: float


def _walk_positions(stream: "SpmvStream"):
    """The column panel's positions of a seg-k ``stream`` in stream order,
    on its device: each one's entry (its table row, plus SELL_END where it
    ends its segment) and coefficient index t·k + j, each with a pad entry
    0 appended; and the first position of each row 0..V+1 (host
    int64[V + 2])."""
    k, dev = stream.seg_k, stream.slots.device
    nz = stream.raw_wts.view(-1, k) != 0
    coef = torch.nonzero(nz.view(-1)).squeeze(1)
    t = coef // k
    end = torch.ones_like(t, dtype=torch.bool)
    end[:-1] = t[1:] != t[:-1]
    code = stream.slots[t].long() + coef % k + torch.where(end, SELL_END, 0)
    before = torch.zeros(nz.shape[0] + 1, dtype=torch.int64, device=dev)
    before[1:] = nz.sum(1).cumsum(0)
    pad = torch.zeros(1, dtype=torch.int64, device=dev)
    return torch.cat([code, pad]), torch.cat([coef, pad]), before[stream.row_items].cpu().numpy()


def build_sell_layout(stream: "SpmvStream", hub=SELL_HUB, sigma=SELL_SIGMA) -> SellLayout:
    """The :class:`SellLayout` of a :func:`panel_stream`, on its device.

    The host orders rows and units from the rows' position counts (O(V)
    numpy work); the positions are found and expanded on the stream's
    device."""
    t0 = time.perf_counter()
    _admit(stream, SellLayout)
    dev, k = stream.slots.device, stream.seg_k
    if k == 1:  # a position is an item
        p_code, p_coef, row_pos = stream.slots, None, stream.row_items.cpu().numpy()
    else:
        p_code, p_coef, row_pos = _walk_positions(stream)
    start = row_pos[:-1]
    cnt = np.diff(row_pos)                        # positions of rows 0..V
    is_hub = cnt > hub
    nw, jb = SELL_WARPS, SELL_JB

    # lane rows: sorted by count (descending) within windows of sigma rows
    lane_ids = np.flatnonzero(~is_hub)
    order = np.lexsort((-cnt[lane_ids], np.arange(len(lane_ids)) // sigma))
    lane_ids = lane_ids[order]
    n_lu = -(-len(lane_ids) // 32)
    l_row = np.full(n_lu * 32, -1, np.int64)
    l_row[: len(lane_ids)] = lane_ids
    l_row = l_row.reshape(n_lu, 32)
    l_cnt = np.where(l_row >= 0, cnt[np.maximum(l_row, 0)], 0)
    l_base = np.where(l_row >= 0, start[np.maximum(l_row, 0)], 0)

    # hub pieces, numbered row-major; lane l takes positions l, l+32, ...
    hub_ids = np.flatnonzero(is_hub)
    per = 32 * hub
    n_pc = -(-cnt[hub_ids] // per)
    hub_piece = np.concatenate([[0], np.cumsum(n_pc)]).astype(np.int64)
    p_hrow = np.repeat(hub_ids, n_pc)
    p_q = np.arange(len(p_hrow)) - np.repeat(hub_piece[:-1], n_pc)
    p_len = np.minimum(per, cnt[p_hrow] - p_q * per)
    lane = np.arange(32)
    h_cnt = np.maximum(0, (p_len[:, None] - lane[None, :] + 31) // 32)
    h_base = (start[p_hrow] + p_q * per)[:, None] + lane[None, :]
    h_row = np.repeat(p_hrow[:, None], 32, 1)
    h_ord = np.argsort(-p_len, kind="stable")

    # units: hub pieces (longest first), then lane units, padded to whole
    # super-slices
    u_hub = np.concatenate([h_ord, np.full(n_lu, -1)]).astype(np.int64)
    pad = (-len(u_hub)) % nw
    u_row = np.concatenate([h_row[h_ord], l_row, np.full((pad, 32), -1)])
    u_cnt = np.concatenate([h_cnt[h_ord], l_cnt, np.zeros((pad, 32), np.int64)])
    u_base = np.concatenate([h_base[h_ord], l_base, np.zeros((pad, 32), np.int64)])
    u_hub = np.concatenate([u_hub, np.full(pad, -1)])
    n_ss = len(u_hub) // nw
    ss_len = u_cnt.reshape(n_ss, nw * 32).max(1, initial=0)
    ss_chunks = np.maximum(1, -(-ss_len // jb))
    chunk_ss = np.repeat(np.arange(n_ss), ss_chunks)
    chunk_jb = np.arange(len(chunk_ss)) - np.repeat(np.cumsum(ss_chunks) - ss_chunks, ss_chunks)

    # entries [chunk, warp, jj, lane] -> position, on the device
    def d(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)

    u = (d(chunk_ss * nw)[:, None, None, None]
         + torch.arange(nw, device=dev)[None, :, None, None])
    j = (d(chunk_jb * jb)[:, None, None, None]
         + torch.arange(jb, device=dev)[None, None, :, None])
    ln = torch.arange(32, device=dev)
    in_hub = d(u_hub >= 0, torch.bool)[u]
    pos = torch.where(j < d(u_cnt)[u, ln], d(u_base)[u, ln] + torch.where(in_hub, 32, 1) * j,
                      -1).reshape(-1)
    real = pos >= 0
    code = torch.where(real, p_code[pos.clamp(min=0)], 0)
    if k == 1:
        item = pos
        first = stream.row_items[:-1].clamp(max=stream.slots.numel() - 1)
        has = stream.row_items[1:] > stream.row_items[:-1]
    else:
        # a hub piece's lanes split segments: each position its own term
        code |= torch.where(in_hub.expand(-1, -1, jb, 32).reshape(-1) & real, SELL_END, 0)
        code -= torch.where(code >= SELL_END, 0x10000, 0)   # as int16
        item = torch.where(real, p_coef[pos.clamp(min=0)], -1)
        first = p_coef[d(np.minimum(start, p_coef.numel() - 1))]
        has = d(cnt > 0, torch.bool)

    def per_row(a, idx):
        """Each row's value at its first position (0 for a row with none)."""
        return torch.where(has, a[idx], torch.zeros((), dtype=a.dtype, device=dev))

    return SellLayout(
        slots=code.to(torch.int16),  # rows < V <= 11,448, the end bit as the sign
        item=item.to(torch.int32),
        lane_row=d(u_row.reshape(-1), torch.int32),
        lane_cnt=d(u_cnt.reshape(-1), torch.int32),
        lane_base=d(np.where(u_cnt > 0, u_base, 0).reshape(-1), torch.int32),
        unit_hub=d(u_hub, torch.int32),
        ss_chunks=d(ss_chunks, torch.int32),
        hub_rows=d(hub_ids, torch.int32),
        hub_piece=d(hub_piece, torch.int32),
        row_scale=per_row(stream.scales, first // k),
        row_wts=per_row(stream.wts, first),
        n_chunks=int(len(chunk_ss)),
        n_pieces=int(hub_piece[-1]),
        host_ms=1e3 * (time.perf_counter() - t0),
    )


# The packed-lane panel (csrc/spmv.cu:spmv_packed).  Its chunks are the
# sliced layout's (SELL_JB positions a lane, SELL_CHUNK a chunk), and its
# panel holds a 16-byte slab of the PACK_ROWS most-read table rows beside
# the ring.  Each stream position is a 16-bit entry: the row's panel
# index, or PACK_COLD plus its table row for a cold row (outside the
# panel), so V is at most PACK_MAX_V.  Rows of more than PACK_PIECE items
# are cut into pieces of that many, joined at the end.  It runs uniform
# seg-1 streams past sell_fits whose rows of more than SELL_HUB items hold
# at least TILES_HUB_SHARE of the items (where the L2 column tiles lose)
# and whose panel rows take at least PACK_HOT_SHARE of the reads: on an
# H100 every f32 and bf16 form beat the row tiles at R-MAT 14, 99.7% of
# the reads; with the panel cut to 10,240 rows (99.3%) B2 f32 unpinned
# lost (PERF.md §6).
PACK_ROWS = (SMEM_BYTES - SELL_BARRIER_BYTES - SELL_STAGES * SELL_CHUNK * 2) // 16  # 11,448
PACK_COLD = 0x4000
PACK_MAX_V = PACK_COLD  # the entry's 14-bit table row
PACK_PIECE = 512
PACK_HOT_SHARE = 0.995


def hot_share(stream: "SpmvStream", rows: int = PACK_ROWS) -> float:
    """The share of ``stream``'s items that read its ``rows`` most-read
    table rows (host numpy)."""
    n = int(stream.row_items[-1])
    reads = np.bincount(stream.slots[:n].cpu().numpy(), minlength=1)
    return float(np.sort(reads)[::-1][:rows].sum() / max(n, 1))


def runs_packed(stream: "SpmvStream") -> bool:
    """Whether B1/B2 run ``stream`` as the packed-lane panel: a uniform
    seg-1 stream past :func:`sell_fits` with V <= PACK_MAX_V, a
    :func:`hub_share` of at least TILES_HUB_SHARE and a :func:`hot_share`
    of at least PACK_HOT_SHARE."""
    return (stream.seg_k == 1 and stream.uniform and not sell_fits(stream.n_nodes)
            and stream.n_nodes <= PACK_MAX_V and hub_share(stream) >= TILES_HUB_SHARE
            and hot_share(stream) >= PACK_HOT_SHARE)


@dataclasses.dataclass(frozen=True)
class PackedLayout(_Tensors):
    """A uniform seg-1 item stream in the order the packed-lane panel of
    kernels B1/B2 walks it.

    Rows of at most ``PACK_PIECE`` items are one *segment* each, items in
    stream order.  Longer rows are cut into pieces of ``PACK_PIECE`` items,
    each a segment: first their hot items (rows in the panel), then their
    cold ones, each in stream order.  Segments sorted by length (longest
    first) are dealt 32 to a *unit*, one to a lane; a unit is as long as
    its longest segment, and the lanes with shorter ones idle at its end.
    Each consumer warp w walks units ``warp_units[w] .. warp_units[w+1]``
    back to back (the warps' totals near equal, long and short units
    alternating); at a unit's end every lane flushes its segment's sums and
    moves on to its next.  The segments with a cold item fill units of
    their own, so a cold read stalls few of a warp's groups.  Walk position t of warp w lies in chunk
    t // SELL_JB at ``chunk·SELL_CHUNK + (w·SELL_JB + t % SELL_JB)·32 +
    lane``, as in :class:`SellLayout`.

    ``codes[p]`` is position p's entry: the panel index of the item's table
    row where it is one of the ``hot_rows`` (the panel's rows, ascending),
    else ``PACK_COLD`` plus the row; pads are 0.  ``row_code[r]`` is row
    r's entry.  Chunk ch's distinct cold rows are ``cold_rows[cold_beg[ch]
    .. cold_beg[ch+1]]`` (ascending), which the kernel prefetches.
    ``item[p]`` is the stream item (-1 for a pad).  Per unit lane:
    ``lane_row`` the output row, ``-2 - piece`` for a piece, -1 for none;
    ``lane_cnt`` its items; ``lane_wts`` / ``lane_scale`` the row's folded
    weight (B1) and scale (B2).  Row ``hub_rows[h]`` sums pieces
    ``hub_piece[h] .. hub_piece[h+1]`` in that order, then B2 scales it by
    ``row_scale``.  ``empty_rows`` have no items and are written as zeros.
    ``host_ms``: host time of the build.
    """

    codes: torch.Tensor       # int16[NC * SELL_CHUNK], read as uint16
    item: torch.Tensor        # int32[NC * SELL_CHUNK]
    hot_rows: torch.Tensor    # int32[H]
    row_code: torch.Tensor    # int16[V], read as uint16
    cold_beg: torch.Tensor    # int32[NC + 1]
    cold_rows: torch.Tensor   # int32[cold_beg[NC]]
    lane_row: torch.Tensor    # int32[NU * 32]
    lane_cnt: torch.Tensor    # int32[NU * 32]
    lane_wts: torch.Tensor    # float32[NU * 32]
    lane_scale: torch.Tensor  # float32[NU * 32]
    warp_units: torch.Tensor  # int32[SELL_WARPS + 1]
    hub_rows: torch.Tensor    # int32[NH]
    hub_piece: torch.Tensor   # int32[NH + 1]
    row_scale: torch.Tensor   # float32[V + 1]
    empty_rows: torch.Tensor  # int32[NE]
    n_chunks: int
    n_pieces: int
    host_ms: float


def _deal_units(u_len: np.ndarray, n_warps: int):
    """Units (lengths, longest first) dealt to ``n_warps`` warps, each next
    unit to the warp with the least so far (ties to the lower warp); each
    warp's units alternate from its longest and its shortest, so a short
    unit follows a long one.  Returns (walk order of the units, the first
    unit of each warp and one past the last)."""
    heap = [(0, w) for w in range(n_warps)]
    mine = [[] for _ in range(n_warps)]
    for u in np.argsort(-u_len, kind="stable"):
        total, w = heapq.heappop(heap)
        mine[w].append(u)
        heapq.heappush(heap, (total + int(u_len[u]), w))
    order = []
    for units in mine:
        lo, hi = 0, len(units) - 1
        while lo <= hi:
            order.append(units[lo])
            if lo != hi:
                order.append(units[hi])
            lo, hi = lo + 1, hi - 1
    bounds = np.concatenate([[0], np.cumsum([len(m) for m in mine])])
    return np.asarray(order, np.int64), bounds


def build_packed_layout(stream: "SpmvStream", hot: Optional[int] = None) -> PackedLayout:
    """The :class:`PackedLayout` of a uniform seg-1 ``stream`` with V <=
    PACK_MAX_V, built in host numpy and moved to the stream's device; its
    panel holds the ``hot`` most-read table rows (default: as many as fit,
    PACK_ROWS), most reads first, ties to the lower row."""
    t0 = time.perf_counter()
    _admit(stream, PackedLayout)
    v = stream.n_nodes
    if not 1 <= v <= PACK_MAX_V:
        raise ValueError(f"the packed layout's 16-bit entry takes 1 <= V <= {PACK_MAX_V}, "
                         f"got {v}")
    h = min(v, PACK_ROWS) if hot is None else int(hot)
    if not 1 <= h <= min(v, PACK_ROWS):
        raise ValueError(f"the panel holds 1 .. {min(v, PACK_ROWS)} rows, got {h}")
    nw, jb, chunk = SELL_WARPS, SELL_JB, SELL_CHUNK
    dev = stream.slots.device
    ri = stream.row_items.cpu().numpy()
    start, cnt = ri[:-1], np.diff(ri)              # rows 0..V
    n = int(ri[-1])
    slots = stream.slots[:n].cpu().numpy().astype(np.int64)
    wts = stream.wts[:n].cpu().numpy()
    scales = stream.scales[:n].cpu().numpy()

    # the panel: the h most-read rows, ascending
    reads = np.bincount(slots, minlength=v)
    hot_rows = np.sort(np.lexsort((np.arange(v), -reads))[:h])
    row_code = PACK_COLD + np.arange(v)
    row_code[hot_rows] = np.arange(h)

    # segments: a row of at most PACK_PIECE items, in stream order; or a piece
    # of a longer row, whose items are taken hot ones first, then cold ones
    # (each in stream order), PACK_PIECE at a time, so its cold reads share
    # few pieces (pieces numbered row-major).  perm lists the items so that
    # each segment is a run of it.
    long = cnt > PACK_PIECE
    n_all = np.repeat(np.arange(v + 1), cnt)
    cold_item = row_code[slots] >= PACK_COLD
    perm = np.argsort(2 * n_all + (long[n_all] & cold_item), kind="stable")
    n_cold = np.bincount(n_all, weights=cold_item, minlength=v + 1).astype(np.int64)
    n_hot = cnt - n_cold
    pc_hot = np.where(long, -(-n_hot // PACK_PIECE), 0)
    pc_cold = np.where(long, -(-n_cold // PACK_PIECE), 0)
    n_seg = np.where(cnt == 0, 0, np.where(long, pc_hot + pc_cold, 1))
    s_row = np.repeat(np.arange(v + 1), n_seg)
    s_q = np.arange(len(s_row)) - np.repeat(np.cumsum(n_seg) - n_seg, n_seg)
    in_cold = long[s_row] & (s_q >= pc_hot[s_row])
    q_in = np.where(in_cold, s_q - pc_hot[s_row], s_q)          # piece within its class
    base = start[s_row] + np.where(in_cold, n_hot[s_row], 0)    # the class's first item
    s_beg = base + q_in * PACK_PIECE
    s_len = np.where(long[s_row],
                     np.minimum(np.where(in_cold, n_cold[s_row], n_hot[s_row]) - q_in * PACK_PIECE,
                                PACK_PIECE),
                     cnt[s_row])
    hub_ids = np.flatnonzero(long)
    hub_piece = np.concatenate([[0], np.cumsum(n_seg[hub_ids])]).astype(np.int64)
    first_piece = np.zeros(v + 1, np.int64)
    first_piece[hub_ids] = hub_piece[:-1]
    s_dest = np.where(long[s_row], -2 - (first_piece[s_row] + s_q), s_row)

    # units of 32 segments, longest first, dealt to the warps; the segments
    # with a cold item fill units of their own
    cold_cum = np.concatenate([[0], np.cumsum(cold_item[perm])])
    s_cold = cold_cum[s_beg + s_len] > cold_cum[s_beg]
    o = []
    for part in (np.flatnonzero(s_cold), np.flatnonzero(~s_cold)):
        o += [part[np.argsort(-s_len[part], kind="stable")], np.full(-len(part) % 32, -1)]
    o = np.concatenate(o).astype(np.int64)
    if len(o) == 0:
        o = np.full(32, -1)
    n_u = len(o) // 32
    real = o >= 0
    pick = np.maximum(o, 0)
    u_dest = np.where(real, s_dest[pick] if len(s_dest) else 0, -1).reshape(n_u, 32)
    u_len = np.where(real, s_len[pick] if len(s_len) else 0, 0).reshape(n_u, 32)
    u_beg = np.where(real, s_beg[pick] if len(s_beg) else 0, 0).reshape(n_u, 32)
    walk, warp_units = _deal_units(u_len.max(1), nw)
    u_dest, u_len, u_beg = u_dest[walk], u_len[walk], u_beg[walk]
    u_size = u_len.max(1)
    u_warp = np.repeat(np.arange(nw), np.diff(warp_units))
    u_off = np.cumsum(u_size) - u_size              # walk offset within its warp
    u_off -= np.concatenate([[0], np.cumsum(u_size)])[warp_units[:-1]][u_warp]
    per_warp = np.bincount(u_warp, weights=u_size, minlength=nw)
    n_chunks = max(1, int(-(-per_warp.max() // jb)))

    # positions, one per (unit, lane, item)
    m = u_len.reshape(-1)
    k = np.arange(int(m.sum())) - np.repeat(np.cumsum(m) - m, m)
    t = np.repeat(np.repeat(u_off, 32), m) + k
    w = np.repeat(np.repeat(u_warp, 32), m)
    lane = np.repeat(np.tile(np.arange(32), n_u), m)
    pos = (t // jb) * chunk + (w * jb + t % jb) * 32 + lane
    items = perm[np.repeat(u_beg.reshape(-1), m) + k]
    item = np.full(n_chunks * chunk, -1, np.int64)
    item[pos] = items
    codes = np.zeros(n_chunks * chunk, np.int64)
    codes[pos] = row_code[slots[items]]
    # each chunk's distinct cold rows, for the kernel's prefetch
    cold = codes[pos] >= PACK_COLD
    key = np.unique((pos[cold] // chunk) * v + slots[items[cold]])
    cold_beg = np.searchsorted(key // v, np.arange(n_chunks + 1))

    first = perm[np.minimum(u_beg.reshape(-1), max(n - 1, 0))] if n else 0
    has = u_len.reshape(-1) > 0
    row_scale = np.zeros(v + 1, np.float32)
    row_scale[cnt > 0] = scales[start[cnt > 0]]

    def d(a, dt):
        host = {torch.int16: np.int16, torch.int32: np.int32, torch.float32: np.float32}[dt]
        return torch.from_numpy(np.ascontiguousarray(a, dtype=host)).to(dev)

    return PackedLayout(
        codes=d(codes.astype(np.uint16).view(np.int16), torch.int16),
        item=d(item, torch.int32),
        hot_rows=d(hot_rows, torch.int32),
        row_code=d(row_code.astype(np.uint16).view(np.int16), torch.int16),
        cold_beg=d(cold_beg, torch.int32),
        cold_rows=d(key % v, torch.int32),
        lane_row=d(u_dest.reshape(-1), torch.int32),
        lane_cnt=d(u_len.reshape(-1), torch.int32),
        lane_wts=d(np.where(has, wts[first] if n else 0, 0), torch.float32),
        lane_scale=d(np.where(has, scales[first] if n else 0, 0), torch.float32),
        warp_units=d(warp_units, torch.int32),
        hub_rows=d(hub_ids, torch.int32),
        hub_piece=d(hub_piece, torch.int32),
        row_scale=d(row_scale, torch.float32),
        empty_rows=d(np.flatnonzero(cnt == 0), torch.int32),
        n_chunks=n_chunks,
        n_pieces=int(hub_piece[-1]),
        host_ms=1e3 * (time.perf_counter() - t0),
    )


# The L2 column tiles (csrc/spmv.cu:spmv_tiles): a warp sums one row (or a
# hub row's piece of SELL_HUB items) over a tile of 256 f32 columns, and
# blocks run tile by tile, so the rows a tile reads come from L2.  They
# run f32 products over seg-1 streams whose hub rows (more than SELL_HUB
# items) hold less than this share of the items: on an H100 they beat the
# row tiles at 0% (the arxiv shape) and 0.8% (V = 60,000) and lost at 58%
# (R-MAT 14), in bf16, and over seg-2 streams (PERF.md).
TILES_HUB_SHARE = 0.25


def hub_share(stream: "SpmvStream") -> float:
    """The share of ``stream``'s items that lie in rows of more than
    SELL_HUB items (host numpy from its row offsets)."""
    cnt = np.diff(stream.row_items.cpu().numpy())
    return float(cnt[cnt > SELL_HUB].sum() / max(cnt.sum(), 1))


@dataclasses.dataclass(frozen=True)
class TilePlan(_Tensors):
    """What the L2 column tiles need besides the stream: rows of more than
    ``SELL_HUB`` items (``hub_rows``, ascending) are cut into pieces of
    ``SELL_HUB`` items in row order; hub row ``hub_rows[h]`` sums pieces
    ``hub_piece[h] .. hub_piece[h+1]`` in that order, piece p being items
    ``piece_beg[p]`` .. (at most ``SELL_HUB``) of row ``piece_row[p]``.
    ``host_ms``: host time of the build."""

    hub_rows: torch.Tensor   # int32[NH]
    hub_piece: torch.Tensor  # int32[NH + 1]
    piece_row: torch.Tensor  # int32[NP]
    piece_beg: torch.Tensor  # int64[NP]
    n_pieces: int
    host_ms: float


def build_tile_plan(stream: "SpmvStream") -> TilePlan:
    """The :class:`TilePlan` of a seg-1 ``stream`` (host numpy from its row
    offsets), on its device."""
    t0 = time.perf_counter()
    _admit(stream, TilePlan)
    row_items = stream.row_items.cpu().numpy()
    cnt = np.diff(row_items)
    hub_ids = np.flatnonzero(cnt > SELL_HUB)
    n_pc = -(-cnt[hub_ids] // SELL_HUB)
    hub_piece = np.concatenate([[0], np.cumsum(n_pc)])
    piece_row = np.repeat(hub_ids, n_pc)
    q = np.arange(len(piece_row)) - np.repeat(hub_piece[:-1], n_pc)
    dev = stream.slots.device

    def d(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)

    return TilePlan(
        hub_rows=d(hub_ids, torch.int32),
        hub_piece=d(hub_piece, torch.int32),
        piece_row=d(piece_row, torch.int32),
        piece_beg=d(row_items[piece_row] + q * SELL_HUB, torch.int64),
        n_pieces=int(hub_piece[-1]),
        host_ms=1e3 * (time.perf_counter() - t0),
    )


# Each layout type: its design, its build, and the streams that design
# takes (its admission rule, held by the build, :func:`with_layout` and the
# launch).
_DESIGNS = {
    SellLayout: ("panel", build_sell_layout, panel_stream,
                 "a uniform seg-1 stream or a mask-uniform seg-2 or seg-4 stream"),
    PackedLayout: ("packed", build_packed_layout, lambda s: s.seg_k == 1 and s.uniform,
                   "a uniform seg-1 stream"),
    TilePlan: ("tiles", build_tile_plan, lambda s: s.seg_k == 1, "a seg-1 stream"),
}


def _admit(stream: "SpmvStream", kind: type) -> None:
    """Raise unless the design of layout type ``kind`` takes ``stream``."""
    if kind not in _DESIGNS:
        raise TypeError(f"a stream's layout is a SellLayout, PackedLayout or TilePlan, "
                        f"got {kind.__name__}")
    design, _, takes, what = _DESIGNS[kind]
    if not takes(stream):
        raise ValueError(f"a {kind.__name__} ({design} design) takes {what}")


def with_layout(stream: "SpmvStream", layout) -> "SpmvStream":
    """``stream`` carrying ``layout`` (a :class:`SellLayout`,
    :class:`PackedLayout` or :class:`TilePlan`) in place of whatever layout
    it had, or none for None (row tiles); raises where ``layout``'s design
    does not take the stream."""
    if layout is not None:
        _admit(stream, type(layout))
    return dataclasses.replace(stream, layout=layout)


def row_tiles(stream: "SpmvStream") -> "SpmvStream":
    """``stream`` without its layout: B1/B2 run it as row tiles."""
    return with_layout(stream, None)


def design_rule(stream: "SpmvStream") -> str:
    """The design a stream built on the card gets, from its shape: the
    column panel where :func:`runs_panel` holds; else the packed-lane panel
    where :func:`runs_packed` does; else the L2 column tiles for a seg-1
    stream whose :func:`hub_share` is below TILES_HUB_SHARE; else row
    tiles."""
    if runs_panel(stream):
        return "panel"
    if runs_packed(stream):
        return "packed"
    if stream.seg_k == 1 and hub_share(stream) < TILES_HUB_SHARE:
        return "tiles"
    return "rows"


def _with_layout(stream: "SpmvStream") -> "SpmvStream":
    """``stream`` with the layout of its :func:`design_rule` where it lies
    on a CUDA device and has none; unchanged otherwise."""
    if stream.layout is not None or not stream.slots.is_cuda:
        return stream
    build = {d: b for d, b, _, _ in _DESIGNS.values()}.get(design_rule(stream))
    return stream if build is None else dataclasses.replace(stream, layout=build(stream))


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
    (int64[V+2]).  ``layout``: on a CUDA device, what the design that
    :func:`design_rule` gives the stream walks, built beside these fields:
    the stream in the sliced order of the column panel (:class:`SellLayout`)
    or in the order of the packed-lane panel (:class:`PackedLayout`), or
    the plan of the L2 column tiles (:class:`TilePlan`); None for row
    tiles.  ``mask_uniform`` (seg_k > 1, decided on the host from the
    weights when the stream is made): in every row the nonzero raw
    coefficients are 1.0, the folded ones nonzero exactly there and all
    equal, so the column panel's one weight a row and unweighted sums give
    the row tiles' terms; ``uniform`` stays False, as graphtpu has it.
    ``host_ms``: host time of the numpy build, up to the uploads of
    :func:`stream_from_numpy`.
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
    mask_uniform: bool = False  # seg-k: coefficients are masks of one value a row
    layout: Union[SellLayout, PackedLayout, TilePlan, None] = None
    host_ms: float = 0.0

    def to(self, device) -> "SpmvStream":
        move = {
            f: getattr(self, f).to(device)
            for f in ("slots", "wts", "pos", "raw_wts", "scales", "row_items")
        }
        if self.layout is not None:
            move["layout"] = self.layout.to(device)
        return _with_layout(dataclasses.replace(self, **move))


def stream_from_numpy(
    slots, wts, pos, raw_wts, scales, n_nodes, n_items, block_items, uniform,
    seg_k=1, device="cpu", t0=None,
) -> SpmvStream:
    """An :class:`SpmvStream` from host arrays (the fields of the JAX
    package's stream after ``np.asarray``), adding the per-row item offsets
    and, on a CUDA device, the layout of its :func:`design_rule`.
    ``host_ms`` counts from ``t0`` (a ``time.perf_counter()`` reading; by
    default this call's start) to the uploads."""
    t0 = time.perf_counter() if t0 is None else t0
    pos = np.asarray(pos, np.int32)
    row_items = np.searchsorted(pos, np.arange(n_nodes + 2)).astype(np.int64)
    masks = seg_k > 1 and _mask_uniform(wts, raw_wts, pos, seg_k)

    def t(a, dt):
        return torch.tensor(np.asarray(a, dtype=dt), device=device)

    host_ms = 1e3 * (time.perf_counter() - t0)
    return _with_layout(SpmvStream(
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
        mask_uniform=bool(masks),
        host_ms=host_ms,
    ))


def _mask_uniform(wts, raw_wts, pos, k) -> bool:
    """:attr:`SpmvStream.mask_uniform` of a seg-``k`` stream's host arrays."""
    w = np.asarray(wts, np.float32).reshape(-1, k)
    raw = np.asarray(raw_wts, np.float32).reshape(-1, k)
    nz = raw != 0
    if not (np.array_equal(nz, w != 0) and (raw[nz] == 1.0).all()):
        return False
    vals = w[nz]                                   # stream order: item t, then j
    rows = np.repeat(np.asarray(pos), k)[nz.reshape(-1)]
    new = np.ones(len(rows), bool)
    new[1:] = rows[1:] != rows[:-1]
    return bool(np.array_equal(vals, vals[new][np.cumsum(new) - 1]))


def _row_scale(rp, wsrc, v):
    """float32[V]: 1/Σw per row, 0 for rows with no weight."""
    d = np.diff(rp)
    # float64 sums in edge order, as np.add.at would give them
    denom = np.bincount(np.repeat(np.arange(v), d), weights=wsrc, minlength=v)
    return np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0)


def build_spmv_stream(
    g: Graph, weighted: bool = False, block_items: int = 1024, device=None
) -> SpmvStream:
    """One item per CSR slot, one dummy item per isolated row (numpy)."""
    t0 = time.perf_counter()
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
    # the real items are the CSR slots in order; isolated rows' dummies
    # are the rest
    real = np.repeat(d > 0, cnt)
    slots = np.zeros(t_real, np.int64)
    wts = np.zeros(t_real, np.float32)
    raw = np.zeros(t_real, np.float32)
    slots[real] = col
    wts[real] = wsrc * scale.astype(np.float32)[np.repeat(np.arange(v), d)]
    raw[real] = wsrc
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
        device=device or g.device, t0=t0,
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
    t0 = time.perf_counter()
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
        seg_k=k, device=device or g.device, t0=t0,
    )


def _first_item_scale(stream: SpmvStream) -> torch.Tensor:
    """float32[V+1]: each output row's scale, taken from its first item
    (0 for a row with no items)."""
    first = stream.row_items[:-1]
    has = stream.row_items[1:] > first
    s = stream.scales[first.clamp(max=stream.scales.numel() - 1)]
    return torch.where(has, s, torch.zeros_like(s))


def scatter_rows_plain(
    pos: torch.Tensor,
    n_out: int,
    c: int,
    temp_rows: int,
    rows_of,
    reduce: str = "sum",
    row_scale: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """[n_out, c] in ``dtype``: the item rows reduced into their output rows.

    Runs in column blocks that keep the [temp_rows, C_blk] temporaries near
    1 GB.  For each block [lo, hi), ``rows_of(lo, hi)`` gives the items'
    [T, hi-lo] f32 rows, reduced by int64 ``pos`` in f32: "sum" by
    ``index_add_``, "amax" by ``scatter_reduce_`` (rows with no item stay
    0).  ``row_scale`` ([n_out, 1] f32), when given, then scales each row.
    """
    dev = pos.device
    out = torch.empty((n_out, c), dtype=dtype, device=dev)
    c_blk = max(1, min(c, _PLAIN_TEMP_ELEMS // max(temp_rows, 1)))
    for lo in range(0, c, c_blk):
        hi = min(c, lo + c_blk)
        rows = rows_of(lo, hi)
        acc = torch.zeros((n_out, hi - lo), dtype=torch.float32, device=dev)
        if reduce == "sum":
            acc.index_add_(0, pos, rows)
        else:
            acc.scatter_reduce_(0, pos[:, None].expand_as(rows), rows, "amax",
                                include_self=False)
        if row_scale is not None:
            acc = acc * row_scale
        out[:, lo:hi] = acc.to(dtype)
    return out


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
    row_scale = _first_item_scale(stream).to(dev)[:, None] if mode == "fast" else None

    def rows_of(lo, hi):
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
        return rows

    return scatter_rows_plain(pos, v + 1, c, t_total * k, rows_of,
                              row_scale=row_scale, dtype=table.dtype)


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
    raises; there is no other path.  The kernel runs the design of
    :func:`spmv_design` (``csrc/spmv.cu``), set by ``stream.layout``: the
    column panel over a :class:`SellLayout`, the packed-lane panel over a
    :class:`PackedLayout`, the L2 column tiles over a :class:`TilePlan`, or
    row tiles.
    """
    _check_mode(mode, table)
    if table.device.type == "cpu":
        return spmv_plain(stream, table, mode, table_scale)
    if table.device.type != "cuda":
        raise RuntimeError(f"no spmv kernel for device {table.device}")
    return _spmv_cuda(stream, table, mode, table_scale)


def sell_launch_args(lay: SellLayout, c: int, kahan: bool, device):
    """``(byref(GtSell), hub_acc)``: the arguments of a column-panel launch
    over ``lay`` at ``c`` columns and the scratch of its hub rows (None
    without hub pieces), to be held until the launch is enqueued.  B1 and
    X2 (``kahan``) read each row's folded weight, B2 and X3 its scale."""
    from graphtpu_torch.kernels import _build

    hub_acc = None
    if lay.n_pieces:
        pairs = 2 if kahan else 1  # (sum, compensation) or sum
        hub_acc = torch.empty(pairs * lay.n_pieces * c, dtype=torch.float32, device=device)
    args = _build.GtSell()
    fields = (lay.slots, lay.lane_row, lay.lane_cnt, lay.lane_base, lay.unit_hub,
              lay.ss_chunks, lay.hub_rows, lay.hub_piece,
              lay.row_wts if kahan else lay.row_scale)
    for name, f in zip(("slots", "lane_row", "lane_cnt", "lane_base", "unit_hub",
                        "ss_chunks", "hub_rows", "hub_piece", "row_w"), fields):
        setattr(args, name, f.data_ptr())
    args.hub_acc = None if hub_acc is None else hub_acc.data_ptr()
    args.n_chunks, args.n_ss = lay.n_chunks, lay.ss_chunks.numel()
    args.n_hub, args.n_pieces = lay.hub_rows.numel(), lay.n_pieces
    return ctypes.byref(args), hub_acc


def packed_launch_args(lay: PackedLayout, c: int, kahan: bool, device):
    """``(byref(GtPacked), hub_acc)``: the arguments of a packed-lane launch
    over ``lay`` at ``c`` columns and the scratch of its pieces (None
    without pieces), to be held until the launch is enqueued.  B1
    (``kahan``) reads each lane's folded weight, B2 its scale."""
    from graphtpu_torch.kernels import _build

    hub_acc = None
    if lay.n_pieces:
        hub_acc = torch.empty((2 if kahan else 1) * lay.n_pieces * c, dtype=torch.float32,
                              device=device)
    args = _build.GtPacked()
    fields = dict(codes=lay.codes, hot_rows=lay.hot_rows, row_code=lay.row_code,
                  cold_beg=lay.cold_beg, cold_rows=lay.cold_rows,
                  lane_row=lay.lane_row, lane_cnt=lay.lane_cnt,
                  lane_w=lay.lane_wts if kahan else lay.lane_scale, warp_units=lay.warp_units,
                  hub_rows=lay.hub_rows, hub_piece=lay.hub_piece, row_w=lay.row_scale,
                  empty_rows=lay.empty_rows)
    for name, f in fields.items():
        setattr(args, name, f.data_ptr())
    args.hub_acc = None if hub_acc is None else hub_acc.data_ptr()
    args.n_chunks, args.n_hot = lay.n_chunks, lay.hot_rows.numel()
    args.n_hub, args.n_pieces = lay.hub_rows.numel(), lay.n_pieces
    args.n_empty = lay.empty_rows.numel()
    return ctypes.byref(args), hub_acc


def tiles_launch_args(plan: TilePlan, c: int, kahan: bool, device):
    """``(byref(GtTiles), acc)``: the L2 column tiles' plan at ``c``
    columns and the scratch of its hub pieces (None without hub rows), to
    be held until the launch is enqueued."""
    from graphtpu_torch.kernels import _build

    acc = None
    if plan.n_pieces:
        acc = torch.empty((2 if kahan else 1) * plan.n_pieces * c, dtype=torch.float32,
                          device=device)
    args = _build.GtTiles()
    for name in ("hub_rows", "hub_piece", "piece_row", "piece_beg"):
        setattr(args, name, getattr(plan, name).data_ptr())
    args.acc = None if acc is None else acc.data_ptr()
    args.n_hub, args.n_pieces = plan.hub_rows.numel(), plan.n_pieces
    args.hub = SELL_HUB
    return ctypes.byref(args), acc


def _check_placed(device, tensors, layout=None) -> None:
    """Raise unless ``tensors`` and the tensor fields of ``layout`` (a
    stream's layout, or None) are contiguous on ``device``."""
    more = () if layout is None else _tensor_fields(layout).values()
    for f in (*tensors, *more):
        if f.device != device or not f.is_contiguous():
            raise ValueError("stream tensors must be contiguous on the table's device")


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
    kahan = mode == "kahan"
    items = (stream.slots, stream.wts if kahan else stream.raw_wts, stream.scales,
             stream.row_items)
    lay = stream.layout
    _check_placed(table.device, items, lay)
    if lay is not None:
        _admit(stream, type(lay))  # a stream edited after the attach
    design = spmv_design(stream, table.dtype)
    out = torch.empty((v + 1, c), dtype=table.dtype, device=table.device)
    if c == 0:
        return out
    lib = _build.load()
    sell = hub_acc = None  # the layout and its scratch, held until the launch is enqueued
    if design == "panel":
        sell, hub_acc = sell_launch_args(lay, c, kahan, table.device)
    slots, wts, scales, row_items = (f.data_ptr() for f in items)
    pin = table_scale is not None
    scale = ctypes.c_float(float(table_scale) if pin else 0.0)
    mul = int(not (stream.uniform and k == 1))
    bf16 = int(table.dtype == torch.bfloat16)
    with torch.cuda.device(table.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if design == "packed":
            args, hub_acc = packed_launch_args(lay, c, kahan, table.device)
            rc = lib.gt_spmv_packed(args, table.data_ptr(), out.data_ptr(), v, c, int(kahan),
                                    int(pin), scale, bf16, cu_stream)
        elif design == "tiles":
            tiles, hub_acc = tiles_launch_args(lay, c, kahan, table.device)
            rc = lib.gt_spmv_tiles(
                slots, wts, scales, row_items, tiles, table.data_ptr(), out.data_ptr(), v, c,
                int(pin), scale, mul, int(kahan), cu_stream,
            )
        elif kahan:
            rc = lib.gt_spmv_kahan_f32(
                slots, wts, row_items, sell, table.data_ptr(), out.data_ptr(), v, c, k,
                int(pin), scale, cu_stream,
            )
        else:
            rc = lib.gt_spmv_fast(
                slots, wts, scales, row_items, sell, table.data_ptr(), out.data_ptr(), v, c,
                k, int(pin), scale, mul, bf16, cu_stream,
            )
    if rc != 0:
        raise RuntimeError(f"spmv {mode} kernel launch failed: {_build.error_string(rc)}")
    SPMV_LAUNCHES[mode] += 1
    return out


# ---------------------------------------------------------------------------
# reduction tree: out[m, :] = sum_j weights[m, j] * table[slots[m, j], :]
# ---------------------------------------------------------------------------


# The compact level plan of kernel B3's column panel (csrc/gather.cu).  A
# chunk holds GATHER_CHUNK_ROWS mini-rows, 32 for each of the SELL_WARPS
# consumer warps, and is what one ring stage holds.
GATHER_CHUNK_ROWS = SELL_WARPS * 32
GATHER_MAX_W = 8
GATHER_STAGES = 3


def gather_chunk_bytes(width: int) -> int:
    """Bytes of one chunk of the compact plan: 16-bit slots, the f32
    weight and the 8-bit count of each mini-row."""
    return GATHER_CHUNK_ROWS * (2 * width + 4 + 1)


def gather_fits(n_table: int, width: int) -> bool:
    """Whether B3's column panel takes a level of ``width``-slot mini-rows
    over ``n_table`` table rows: a 16-byte slab of every row beside the
    plan's ring of three chunks in one block's shared memory
    (n_table <= 12,504 at W = 8)."""
    room = SMEM_BYTES - SELL_BARRIER_BYTES - GATHER_STAGES * gather_chunk_bytes(width)
    return 1 <= width <= GATHER_MAX_W and 1 <= n_table and n_table * 16 <= room


@dataclasses.dataclass(frozen=True)
class GatherLayout(_Tensors):
    """One tree level as the compact plan kernel B3's column panel reads.

    ``data`` holds ``n_chunks`` chunks of :func:`gather_chunk_bytes` bytes;
    chunk k covers mini-rows 512k .. 512k+511, mini-row 512k + 32u + l
    being lane l of warp u.  In a chunk: int16 slots [16, W, 32] (warp, j,
    lane), then f32 weights [512] (each mini-row's one weight), then uint8
    counts [512].  A mini-row's count is one past its last nonzero weight;
    its slots at j >= count are 0.  ``n_rows``: the level's mini-rows;
    ``n_table``: one past the largest slot, the table rows the panel
    holds.  ``host_ms``: host time of the build."""

    data: torch.Tensor  # uint8[n_chunks * chunk_bytes]
    width: int
    n_rows: int
    n_table: int
    n_chunks: int
    host_ms: float


def build_gather_layout(slots: np.ndarray, weights: np.ndarray) -> Optional[GatherLayout]:
    """The :class:`GatherLayout` of one level ([M, W] int32 slots, f32
    weights, host arrays), built in numpy and held on the host, or None:
    where :func:`gather_fits` refuses it, or where a mini-row's weights
    before its count differ (weighted level 0, which keeps the row tiles).
    Every unweighted tree level, and every deeper level and the last one's
    1/Σw, has one weight a mini-row."""
    t0 = time.perf_counter()
    slots = np.asarray(slots)
    weights = np.asarray(weights, np.float32)
    m, w = slots.shape
    nz = (weights != 0).view(np.uint8)
    cnt = np.zeros(m, np.uint8)  # one past the last nonzero weight
    for j in range(w):
        np.maximum(cnt, nz[:, j] * np.uint8(j + 1), out=cnt)
    valid = np.arange(w, dtype=np.uint8)[None, :] < cnt[:, None]
    sl = np.where(valid, slots, 0)
    n_table = int(sl.max(initial=0)) + 1
    if not gather_fits(n_table, w) or not ((weights == weights[:, :1]) | ~valid).all():
        return None
    n_ch = max(1, -(-m // GATHER_CHUNK_ROWS))
    rows = n_ch * GATHER_CHUNK_ROWS

    def chunks(a, dt, transpose):
        """[rows, ...] padded with zeros, as [n_ch, bytes] of ``dt``."""
        p = np.zeros((rows,) + a.shape[1:], dt)
        p[:m] = a
        if transpose:  # [chunk, warp, lane, j] -> [chunk, warp, j, lane]
            p = p.reshape(n_ch, SELL_WARPS, 32, w).transpose(0, 1, 3, 2)
        return np.ascontiguousarray(p).reshape(n_ch, -1).view(np.uint8)

    data = np.concatenate([chunks(sl, np.int16, True), chunks(weights[:, 0], np.float32, False),
                           chunks(cnt, np.uint8, False)], 1)
    return GatherLayout(data=torch.from_numpy(data.reshape(-1)), width=w, n_rows=m,
                        n_table=n_table, n_chunks=n_ch,
                        host_ms=1e3 * (time.perf_counter() - t0))


@dataclasses.dataclass(frozen=True)
class ReductionTree:
    """Gather plan for P·X over one graph, laid out as graphtpu's.

    ``levels[k]``: int32[M_k, W] row indices into the previous level's
    output (level 0 indexes X by CSR column); pad slots point at row 0 with
    weight 0.  ``weights[k]``: float32[M_k, W] per-slot factors (edge
    weight at level 0, validity deeper, the 1/Σw row scale folded into the
    last level).  The last level yields ``n_nodes`` rows in node order.
    Every level is padded to a block multiple; ``real_rows[k]`` is the
    unpadded M_k, and deeper levels index only that prefix.  ``layouts``:
    on a CUDA device, each level's compact plan (:class:`GatherLayout`)
    where B3's column panel takes it, else None, built on the host from the
    same arrays and moved beside these fields; empty elsewhere.
    """

    levels: Tuple[torch.Tensor, ...]
    weights: Tuple[torch.Tensor, ...]
    width: int
    n_nodes: int
    real_rows: Tuple[int, ...]
    layouts: Tuple[Optional[GatherLayout], ...] = ()

    def layout(self, k: int) -> Optional[GatherLayout]:
        """Level k's compact plan, or None (the row tiles run it)."""
        return self.layouts[k] if self.layouts else None

    @property
    def layout_host_ms(self) -> float:
        """Host ms of building the compact plans (numpy work only, not the
        copy to the card)."""
        return sum(l.host_ms for l in self.layouts if l is not None)

    def to(self, device) -> "ReductionTree":
        return _with_layouts(dataclasses.replace(
            self,
            levels=tuple(l.to(device) for l in self.levels),
            weights=tuple(w.to(device) for w in self.weights),
            layouts=tuple(None if l is None else l.to(device) for l in self.layouts),
        ), self.levels, self.weights)


def _with_layouts(tree: ReductionTree, levels, weights) -> ReductionTree:
    """``tree`` with each level's compact plan, built from ``levels`` and
    ``weights`` (host arrays or tensors of the tree's fields), where it
    lies on a CUDA device and has none; unchanged otherwise."""
    if tree.layouts or not tree.levels or not tree.levels[0].is_cuda:
        return tree

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    plans = (build_gather_layout(host(l), host(w)) for l, w in zip(levels, weights))
    dev = tree.levels[0].device
    return dataclasses.replace(tree, layouts=tuple(
        None if p is None else p.to(dev) for p in plans))


def tree_from_numpy(
    levels, weights, width, n_nodes, real_rows, device="cpu"
) -> ReductionTree:
    """A :class:`ReductionTree` from host arrays (graphtpu's tree fields
    after ``np.asarray``), with its compact plans on a CUDA device."""
    levels = [np.asarray(l, np.int32) for l in levels]
    weights = [np.asarray(w, np.float32) for w in weights]
    return _with_layouts(ReductionTree(
        levels=tuple(torch.tensor(l, device=device) for l in levels),
        weights=tuple(torch.tensor(w, device=device) for w in weights),
        width=int(width),
        n_nodes=int(n_nodes),
        real_rows=tuple(int(r) for r in real_rows),
    ), levels, weights)


def _pad_rows(a: np.ndarray, mult: int, fill) -> np.ndarray:
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad, a.shape[1]), fill, a.dtype)])


def build_reduction_tree(
    g: Graph,
    width: int = 8,
    weighted: bool = False,
    block: int = 256,
    row_scale: Optional[np.ndarray] = None,
    device=None,
) -> ReductionTree:
    """Host-side plan from CSR (numpy; one pass per level).

    Level 1 chops each CSR row into mini-rows of ``width`` slots; each
    deeper level reduces ``width`` partial rows of the level before, until
    each node owns one row.  ``row_scale`` overrides the 1/Σw row scale,
    for a column-restricted block of a larger graph whose local row sums
    are partial.
    """
    rp_h, col_h, w_h, _ = g.host
    rp = rp_h.astype(np.int64)
    col = col_h.astype(np.int64)
    v = g.n_nodes
    d = np.diff(rp)
    w = width
    wsrc = (
        np.asarray(w_h, np.float32)
        if (weighted and w_h is not None)
        else np.ones(len(col), np.float32)
    )
    if row_scale is not None:
        scale = np.asarray(row_scale, np.float32)
        if scale.shape != (v,):
            raise ValueError(f"row_scale has shape {scale.shape}, expected ({v},)")
    else:
        scale = _row_scale(rp, wsrc, v).astype(np.float32)

    # level 1: mini-rows over the CSR column array; pad -> row 0, weight 0
    m = np.maximum(1, -(-d // w))
    m1 = int(m.sum())
    row_of = np.repeat(np.arange(v), m)
    start = np.cumsum(m) - m
    r_local = np.arange(m1) - start[row_of]
    slots = np.zeros((m1, w), np.int64)
    wts = np.zeros((m1, w), np.float32)
    for j in range(w):
        e = rp[:-1][row_of] + r_local * w + j
        ok = e < rp[1:][row_of]
        slots[ok, j] = col[e[ok]]
        wts[ok, j] = wsrc[e[ok]]
    levels, weights = [slots], [wts]

    # levels 2+: reduce mini-row counts by W until one row per node
    cnt = m
    while cnt.max(initial=1) > 1:
        prev_start = np.cumsum(cnt) - cnt
        m2 = np.maximum(1, -(-cnt // w))
        mk = int(m2.sum())
        row_of2 = np.repeat(np.arange(v), m2)
        start2 = np.cumsum(m2) - m2
        r2 = np.arange(mk) - start2[row_of2]
        sl = np.zeros((mk, w), np.int64)
        wt = np.zeros((mk, w), np.float32)
        for j in range(w):
            p = r2 * w + j
            ok = p < cnt[row_of2]
            sl[ok, j] = prev_start[row_of2][ok] + p[ok]
            wt[ok, j] = 1.0
        levels.append(sl)
        weights.append(wt)
        cnt = m2

    weights[-1] = weights[-1] * scale[:, None]
    real = tuple(l.shape[0] for l in levels)
    return tree_from_numpy(
        [_pad_rows(l, block, 0) for l in levels],
        [_pad_rows(x, block, 0.0) for x in weights],
        w, v, real, device=device or g.device,
    )


def gather_rows_sum_plain(
    slots: torch.Tensor, weights: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: [M, W] slots over [N, C] -> [M, C]
    f32, ``acc = x0·w0`` then ``acc = acc + xj·wj`` in j order.  A bf16
    table is widened to f32 before the multiply, as XLA promotes it."""
    s = slots.long()
    w = weights.float()
    acc = table[s[:, 0]].float() * w[:, 0:1]
    for j in range(1, s.shape[1]):
        acc = acc + table[s[:, j]].float() * w[:, j : j + 1]
    return acc


def _check_gather(slots, weights, table, out):
    if slots.dim() != 2 or slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32 [M, W], got {slots.dtype} {tuple(slots.shape)}")
    if weights.shape != slots.shape or weights.dtype != torch.float32:
        raise TypeError("weights must be float32 with the shape of slots")
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be a 2-D float32 or bfloat16 tensor, got {table.dtype}")
    m, c = slots.shape[0], table.shape[1]
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != (m, c)
    ):
        raise ValueError(f"out must be float32 [{m}, {c}], got {out.dtype} {tuple(out.shape)}")
    for t in (weights, table) + (() if out is None else (out,)):
        if t.device != slots.device:
            raise ValueError("slots, weights, table and out must share a device")


def gather_rows_sum(
    slots: torch.Tensor,
    weights: torch.Tensor,
    table: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One tree level: ``out[m] = Σ_j weights[m, j]·table[slots[m, j]]``,
    f32 [M, C], written into ``out`` when given (any row stride, unit
    column stride).

    A CPU table runs :func:`gather_rows_sum_plain`.  A CUDA table launches
    kernel B3 on the current stream (its row tiles; the column panel runs
    only inside :func:`tree_spmm`), or raises; there is no other path.  The
    table may be a column block of a wider tensor (unit column stride).
    Slots are not range-checked on the card.
    """
    _check_gather(slots, weights, table, out)
    if table.device.type == "cpu":
        res = gather_rows_sum_plain(slots, weights, table)
        return res if out is None else out.copy_(res)
    if table.device.type != "cuda":
        raise RuntimeError(f"no gather kernel for device {table.device}")
    return _gather_cuda(slots, weights, table, out)


def _gather_cuda(slots, weights, table, out, layout=None, c=None, table_slabs=False):
    """Launch B3.  ``table`` is row-major, or, between two levels of
    :func:`tree_spmm`, f32 slab-major ``[ceil(c/4), R, 4]`` (``table_slabs``).
    With ``layout``, the level's compact plan, the column panel runs and
    returns the level slab-major, ``[ceil(c/4), M, 4]`` (``out`` must be
    None); without it the row tiles write row-major ``out`` (allocated when
    None)."""
    from graphtpu_torch.kernels import _build

    m, w = slots.shape
    c = table.shape[1] if c is None else c
    if not (slots.is_contiguous() and weights.is_contiguous()):
        raise ValueError("slots and weights must be contiguous")
    if not table_slabs and table.stride(1) != 1 and c > 1:
        raise ValueError("table must have unit column stride")
    if layout is not None:
        if out is not None:
            raise ValueError("the column panel allocates its slab-major output")
        out = torch.empty((-(-c // 4), m, 4), dtype=torch.float32, device=table.device)
    elif out is None:
        out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    elif out.stride(1) != 1 and c > 1:
        raise ValueError("out must have unit column stride")
    if m == 0 or c == 0:
        return out
    lib = _build.load()
    plan = None
    if layout is not None:
        plan = ctypes.byref(_build.GtGather(layout.data.data_ptr(), layout.n_chunks,
                                            layout.n_table))
    ld = table.shape[1] if table_slabs else table.stride(0)
    ldo = m if layout is not None else out.stride(0)
    with torch.cuda.device(table.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.gt_gather_rows_sum(
            slots.data_ptr(), weights.data_ptr(), table.data_ptr(), ld, int(table_slabs),
            out.data_ptr(), ldo, m, w, c,
            int(table.dtype == torch.bfloat16), plan, cu_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: {_build.error_string(rc)}")
    GATHER_LAUNCHES["gather_rows_sum"] += 1
    return out


def tree_spmm(tree: ReductionTree, x: torch.Tensor, col_block: int = 4096) -> torch.Tensor:
    """P·x through the reduction tree: [>=V, C] -> [V, C] f32.

    Column-blocked at ``min(col_block, C)`` so each level's partials stay
    [M_k, col_block]; every block runs every level through kernel B3
    (:func:`gather_rows_sum` on the CPU), level 0 reading the block of
    ``x`` in place and the last level writing its first V rows straight
    into the result.  On the card a level below the last with a compact
    plan (``tree.layout(k)``) runs B3's column panel and passes the next
    level its result slab-major (``[ceil(C_blk/4), M_k, 4]``: the panel
    stores each block's 16-byte slab contiguously, which row-major rows
    would scatter); the next level reads it so.  Every other level runs
    the row tiles.  The bits are those of the row tiles alone, which
    ``dataclasses.replace(tree, layouts=())`` runs.
    """
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a 2-D float32 or bfloat16 tensor, got {x.dtype}")
    if tree.levels[0].device != x.device:
        raise ValueError(f"tree on {tree.levels[0].device}, x on {x.device}")
    v, c = tree.n_nodes, x.shape[1]
    out = torch.empty((v, c), dtype=torch.float32, device=x.device)
    cb = min(col_block, c)
    last = len(tree.levels) - 1
    for lo in range(0, c, max(cb, 1)):
        hi = min(c, lo + cb)
        cur, slabs = x[:, lo:hi], False
        for k in range(last + 1):
            sl, w = tree.levels[k], tree.weights[k]
            dst = out[:, lo:hi] if k == last else None
            if k == last:
                sl, w = sl[:v], w[:v]
            if not x.is_cuda:
                cur = gather_rows_sum(sl, w, cur, out=dst)
                continue
            lay = tree.layout(k) if k < last else None
            cur = _gather_cuda(sl, w, cur, dst, lay, c=hi - lo, table_slabs=slabs)
            slabs = lay is not None
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
