"""Kernels B1/B2 over seg-k streams as the column panel, on the CPU.

A seg-k stream (``build_spmv_segments``) of an unweighted graph has
coefficients that are masks of one value a row, so its sliced layout
(``spmm.build_sell_layout``) holds one 16-bit entry per sub-row with a
nonzero coefficient, with bit 15 where the entry ends its segment.  Here:
the layout holds every such sub-row once and no other; a float32 walk of
it in the kernel's order (partials per segment, joined at the end bit) is
bit-equal to the row tiles' order on lane rows, for B2 to the plain
version's too, and within 1e-5 of graphtpu's Pallas kernels (interpret
mode); the rule that gives each stream its design; the launch arguments;
the ``torch.sparse.mm`` yardstick's CSR and the bound's term count."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import graphtpu
import graphtpu_torch as gt
from graphtpu.kernels import spmm as jspmm
from graphtpu_torch.bench import bounds, generators
from graphtpu_torch.bench.timing import stream_csr
from graphtpu_torch.core.reorder import rcm_order, relabel_graph
from graphtpu_torch.kernels import spmm

torch.set_num_threads(1)

END, ROW = spmm.SELL_END, spmm.SELL_ROW
C = 1024  # the Pallas kernels' column quantum


def _edges(seed, v, n_edges, hub_degree, run):
    """Random edges among rows [0, v - 3) (the last three rows isolated),
    a hub row 0 of ``hub_degree`` distinct neighbours, row 1 joined to a
    run of ``run`` consecutive rows, and row 2 to row v - 4 alone (a window
    clamped at the table's end leaves sub-row 0 masked)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v - 3, size=(n_edges, 2))
    hub = np.stack([np.zeros(hub_degree, np.int64), 1 + rng.permutation(v - 4)[:hub_degree]], 1)
    lo = int(rng.integers(3, v - 3 - run))
    runs = np.stack([np.ones(run, np.int64), np.arange(lo, lo + run)], 1)
    edges = np.concatenate([edges, hub, runs, [[2, v - 4]]])
    return edges[edges[:, 0] != edges[:, 1]]


def _rcm(edges, v):
    """``edges`` relabelled by the RCM order of their graph."""
    inv = np.empty(v, np.int64)
    inv[rcm_order(gt.build_graph(edges, n_nodes=v))] = np.arange(v)
    return inv[edges]


def _graphs(seed=0, v=120, n_edges=300, hub_degree=70, run=9, relabel=True, weighted=False):
    edges = _edges(seed, v, n_edges, hub_degree, run)
    if relabel:
        edges = _rcm(edges, v)
    wts = (np.random.default_rng(seed + 1).random(len(edges)) + 0.1).astype(np.float32)
    wts = wts if weighted else None
    return (gt.build_graph(edges, weights=wts, n_nodes=v),
            graphtpu.build_graph(edges, weights=wts, n_nodes=v))


def _decode(lay):
    """Per entry: (unit, lane, j), its table row, its end bit, and whether it
    is a position (not a pad)."""
    jb, cp = spmm.SELL_JB, spmm.SELL_CHUNK
    p = np.arange(lay.item.numel())
    c, rem = p // cp, p % cp
    w, jj, lane = rem // (32 * jb), (rem // 32) % jb, rem % 32
    ss_chunks = lay.ss_chunks.numpy()
    chunk_ss = np.repeat(np.arange(len(ss_chunks)), ss_chunks)
    first = np.cumsum(ss_chunks) - ss_chunks
    unit = chunk_ss[c] * spmm.SELL_WARPS + w
    j = (c - first[chunk_ss[c]]) * jb + jj
    code = lay.slots.numpy().view(np.uint16).astype(np.int64)
    return unit, lane, j, code & ROW, (code & END) != 0, lay.item.numpy() >= 0


cases = st.tuples(
    st.integers(0, 2**31 - 1),          # seed
    st.integers(40, 160),               # V
    st.integers(0, 600),                # random edges
    st.integers(5, 30),                 # hub degree: over the thresholds below
    st.integers(2, 12),                 # a run of consecutive neighbours
    st.sampled_from([2, 4]),            # seg_k
    st.sampled_from([4, 6]),            # hub threshold
    st.sampled_from([8, 64, 4096]),     # sort window
    st.booleans(),                      # RCM relabel
)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(cases)
def test_seg_layout_holds_the_nonzero_sub_rows(case):
    seed, v, n_edges, hub_degree, run, k, hub, sigma, relabel = case
    g, _ = _graphs(seed, v, n_edges, hub_degree, run, relabel)
    s = spmm.build_spmv_segments(g, k=k, block_items=64)
    assert s.mask_uniform and not s.uniform and spmm.runs_panel(s)
    lay = spmm.build_sell_layout(s, hub=hub, sigma=sigma)
    unit, lane, j, trow, end, real = _decode(lay)
    item = lay.item.numpy()
    lane_row = lay.lane_row.numpy().reshape(-1, 32)
    lane_cnt = lay.lane_cnt.numpy().reshape(-1, 32)
    in_hub = lay.unit_hub.numpy()[unit] >= 0
    raw = s.raw_wts.numpy()
    slots, pos = s.slots.numpy().astype(np.int64), s.pos.numpy()

    # every sub-row with a nonzero coefficient once, no other; the entry's
    # row is the sub-row's table row; pads are 0
    nonzero = np.flatnonzero(raw != 0)
    assert np.array_equal(np.sort(item[real]), nonzero)
    assert np.array_equal(real, j < lane_cnt[unit, lane])
    assert np.array_equal(trow[real], slots[item[real] // k] + item[real] % k)
    assert (trow[~real] == 0).all() and not end[~real].any()
    assert trow.max() < v

    # lane rows walk their sub-rows in stream order, and the end bit marks
    # each segment's last; every hub position has it
    pos_row = lane_row[unit, lane]
    assert np.array_equal(pos_row[real], pos[item[real] // k])
    nxt = np.append(nonzero[1:] // k, -1)
    ends_seg = dict(zip(nonzero, nxt != nonzero // k))
    want_end = np.array([ends_seg[i] for i in item[real]])
    lanes = real & ~in_hub
    order = np.lexsort((j[lanes], lane[lanes], unit[lanes]))
    walked = item[lanes][order]
    rows = pos_row[lanes][order]
    for r in np.unique(rows):
        assert np.array_equal(walked[rows == r], nonzero[pos[nonzero // k] == r])
    assert np.array_equal(end[real & ~in_hub], want_end[~in_hub[real]])
    assert end[real & in_hub].all()

    # rows with more than `hub` positions are the hub rows
    cnt = np.bincount(pos[nonzero // k], minlength=v + 1)
    assert np.array_equal(lay.hub_rows.numpy(), np.flatnonzero(cnt > hub))

    # a float64 mean over the layout's own order equals the oracle
    x = np.random.default_rng(seed + 1).random((v, 3))
    num = np.zeros((v + 1, 3))
    den = np.zeros(v + 1)
    np.add.at(num, pos_row[real], x[trow[real]])
    np.add.at(den, pos_row[real], 1.0)
    got = np.where(den[:v, None] > 0, num[:v] / np.maximum(den[:v, None], 1e-300), 0.0)
    np.testing.assert_allclose(got, spmm.spmm_oracle(g, x), rtol=0, atol=1e-12)


def _kahan_merge(s, cp, s2, c2):
    t = s + s2
    bb = t - s
    err = (s - (t - bb)) + (s2 - bb)
    return t, (cp + c2) - err


def _pinned(x, rows, table_scale):
    """float32 rows of ``x``, pinned: where(col == row, 1, c·x)."""
    val = x[rows]
    if table_scale is None:
        return val
    cols = np.arange(x.shape[1])
    return np.where(cols[None, :] == np.asarray(rows)[:, None], np.float32(1),
                    np.float32(table_scale) * val)


def _walk(s, lay, x, mode, table_scale):
    """The column panel's seg-k walk in float32, in its order: each lane's
    positions in turn, the term (B1 times the row's weight) into its
    segment's partial, the partial into the row sum at the end bit (Kahan
    for B1); a hub piece's lanes folded 16, 8, ..., 1 apart (TwoSum for
    B1), its pieces joined in order; B2 scales each row."""
    f = np.float32
    kahan = mode == "kahan"
    unit, lane, j, trow, end, real = _decode(lay)
    lane_row = lay.lane_row.numpy().reshape(-1, 32)
    unit_hub = lay.unit_hub.numpy()
    rw = (lay.row_wts if kahan else lay.row_scale).numpy()
    n_units = len(unit_hub)
    out = np.zeros((s.n_nodes + 1, x.shape[1]), f)
    acc = np.zeros((lay.n_pieces, 2, x.shape[1]), f)
    order = np.lexsort((j, lane, unit))
    order = order[real[order]]
    key = unit[order] * 32 + lane[order]
    cuts = np.flatnonzero(np.diff(key)) + 1
    by_lane = dict(zip(key[np.r_[0, cuts]] if len(key) else [], np.split(order, cuts)))
    zero = np.zeros(x.shape[1], f)
    for u in range(n_units):
        sums, comps = [], []
        for ln in range(32):
            r = lane_row[u, ln]
            w = rw[r] if r >= 0 else f(0)
            sm, cp, part = zero, zero, zero
            for p in by_lane.get(u * 32 + ln, []):
                val = _pinned(x, [trow[p]], table_scale)[0]
                part = part + (val * w if kahan else val)
                if end[p]:
                    if kahan:
                        y = part - cp
                        t = sm + y
                        cp = (t - sm) - y
                        sm = t
                    else:
                        sm = sm + part
                    part = zero
            sums.append(sm)
            comps.append(cp)
            if unit_hub[u] < 0 and r >= 0:
                out[r] = sm if kahan else sm * w
        if unit_hub[u] >= 0:
            for off in (16, 8, 4, 2, 1):
                for ln in range(off):
                    if kahan:
                        sums[ln], comps[ln] = _kahan_merge(sums[ln], comps[ln], sums[ln + off],
                                                           comps[ln + off])
                    else:
                        sums[ln] = sums[ln] + sums[ln + off]
            acc[unit_hub[u]] = sums[0], comps[0]
    hp, scale = lay.hub_piece.numpy(), lay.row_scale.numpy()
    for h, r in enumerate(lay.hub_rows.numpy()):
        sh, ch = acc[hp[h]]
        for q in range(hp[h] + 1, hp[h + 1]):
            sh, ch = _kahan_merge(sh, ch, *acc[q]) if kahan else (sh + acc[q][0], ch)
        out[r] = sh if kahan else sh * scale[r]
    return out


def _row_tiles(s, x, mode, table_scale):
    """The row tiles' order in float32: each item's k sub-rows (pinned, times
    their coefficient) summed in j order, then one Kahan update (B1) or add
    (B2) a item; B2 scales the row by its first item's scale."""
    f = np.float32
    kahan, k = mode == "kahan", s.seg_k
    w = (s.wts if kahan else s.raw_wts).numpy().reshape(-1, k)
    slots, ri, scales = s.slots.numpy(), s.row_items.numpy(), s.scales.numpy()
    out = np.zeros((s.n_nodes + 1, x.shape[1]), f)
    for r in range(s.n_nodes + 1):
        sm = cp = np.zeros(x.shape[1], f)
        for t in range(ri[r], ri[r + 1]):
            vals = _pinned(x, slots[t] + np.arange(k), table_scale) * w[t][:, None]
            row = vals[0]
            for jj in range(1, k):
                row = row + vals[jj]
            if kahan:
                y = row - cp
                tt = sm + y
                cp = (tt - sm) - y
                sm = tt
            else:
                sm = sm + row
        out[r] = sm if kahan else sm * (scales[ri[r]] if ri[r + 1] > ri[r] else f(0))
    return out


@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
@pytest.mark.parametrize("k", [2, 4])
def test_seg_walk_matches_row_tiles_and_graphtpu(k, mode, table_scale):
    """An RCM-relabelled graph with a hub row of 70 neighbours (at a hub
    threshold of 2, pieces of 64 positions: two), a clamped window and
    isolated rows."""
    tg, jg = _graphs()
    s = spmm.build_spmv_segments(tg, k=k, block_items=64)
    js = jspmm.build_spmv_segments(jg, k=k, block_items=1024)
    lay = spmm.build_sell_layout(s, hub=2, sigma=64)
    assert lay.n_pieces >= 2
    x = np.random.default_rng(6).random((tg.n_nodes, C)).astype(np.float32)
    got = _walk(s, lay, x, mode, table_scale)
    lanes = np.setdiff1d(np.arange(tg.n_nodes + 1), lay.hub_rows.numpy())
    want = _row_tiles(s, x, mode, table_scale)
    assert np.array_equal(got[lanes], want[lanes])
    plain = spmm.spmv_plain(s, torch.from_numpy(x), mode, table_scale).numpy()
    if mode == "fast":
        assert np.array_equal(got[lanes], plain[lanes])
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    pallas = jspmm.spmv_pallas_flat(js, jnp.asarray(x).reshape(-1), C, interpret=True,
                                    mode=mode, table_scale=table_scale)
    pallas = np.asarray(pallas.astype(jnp.float32)).reshape(tg.n_nodes + 1, C)
    np.testing.assert_allclose(got[: tg.n_nodes], pallas[: tg.n_nodes], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case,want", [
    ("seg-2", "panel"),
    ("seg-4", "panel"),
    ("seg-2, V = 11,448", "panel"),
    ("seg-2, V = 11,449", "rows"),
    ("seg-4, V = 11,449", "rows"),
    ("seg-2, weighted", "rows"),
    ("seg-4, weighted", "rows"),
    ("seg-3", "rows"),
])
def test_seg_design_rule(case, want):
    v = 11_449 if "11,449" in case else 11_448 if "11,448" in case else 120
    k = int(case[4])
    weighted = "weighted" in case
    edges = _edges(3, v, 300, 20, 8)
    wts = (np.random.default_rng(4).random(len(edges)) + 0.1).astype(np.float32)
    wts = wts if weighted else None
    s = spmm.build_spmv_segments(gt.build_graph(edges, weights=wts, n_nodes=v),
                                 weighted=weighted, k=k)
    js = jspmm.build_spmv_segments(graphtpu.build_graph(edges, weights=wts, n_nodes=v),
                                   weighted=weighted, k=k)
    assert spmm.design_rule(s) == want
    assert s.uniform is False and s.uniform == js.uniform
    assert s.mask_uniform == (not weighted)
    if want == "rows":
        if weighted:
            with pytest.raises(ValueError, match="mask-uniform"):
                spmm.build_sell_layout(s)
    else:
        assert spmm.build_sell_layout(s).n_chunks >= 1


def test_seg_launch_args_follow_the_kernels_struct():
    """A seg-k layout is passed as a seg-1 one: ``sell_launch_args`` points
    each field of ``struct GtSell`` at its tensor; ``_spmv_cuda`` refuses a
    layout beside a stream that is not mask-uniform before it loads any
    kernel."""
    tg, _ = _graphs()
    for k in (2, 4):
        s = spmm.build_spmv_segments(tg, k=k)
        lay = spmm.build_sell_layout(s, hub=2, sigma=64)
        for kahan, w in ((True, lay.row_wts), (False, lay.row_scale)):
            ref, hub_acc = spmm.sell_launch_args(lay, 5, kahan, "cpu")
            args = ref._obj
            for name in ("slots", "lane_row", "lane_cnt", "lane_base", "unit_hub", "ss_chunks",
                         "hub_rows", "hub_piece"):
                assert getattr(args, name) == getattr(lay, name).data_ptr()
            assert args.row_w == w.data_ptr() and args.hub_acc == hub_acc.data_ptr()
            assert hub_acc.numel() == (2 if kahan else 1) * lay.n_pieces * 5
            assert (args.n_chunks, args.n_pieces) == (lay.n_chunks, lay.n_pieces)
        weighted = dataclasses.replace(spmm.with_layout(s, lay), mask_uniform=False)
        with pytest.raises(ValueError, match="mask-uniform"):
            spmm._spmv_cuda(weighted, torch.zeros((tg.n_nodes, 4)), "kahan", None)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_stream_csr_is_the_streams_product(k, weighted):
    """The ``torch.sparse.mm`` yardstick's CSR holds every sub-row with a
    nonzero coefficient: its product is the plain version's (a CSR of each
    segment's first slot only was 0.6 away at seg-2)."""
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 200, size=(1500, 2))
    wts = (rng.random(1500) + 0.1).astype(np.float32) if weighted else None
    g = gt.build_graph(edges, weights=wts, n_nodes=200)
    s = spmm.build_spmv_segments(relabel_graph(g, rcm_order(g))[0] if k > 1 else g,
                                 weighted=weighted, k=k, block_items=64)
    x = torch.from_numpy(rng.random((200, 16)).astype(np.float32))
    csr = stream_csr(s, s.wts)
    assert csr.values().numel() == int((s.wts != 0).sum())
    got = torch.sparse.mm(csr, x)
    want = spmm.spmv_plain(s, x, "kahan")[:200]
    assert (got - want).abs().max().item() <= 1e-6


def test_bound_counts_nonzero_sub_rows():
    """The bound counts the terms a stream needs: RCM blog's seg-2 and seg-4
    streams read the same 657,924 sub-rows as blog's seg-1 stream, so their
    B1 and B2 operations agree within 2%."""
    g = generators.blog_shaped_graph()
    rcm, _ = relabel_graph(g, rcm_order(g))
    one = spmm.build_spmv_stream(g)
    v = g.n_nodes
    for k in (2, 4):
        seg = spmm.build_spmv_segments(rcm, k=k)
        assert bounds.stream_terms(seg) == g.n_edges
        for mode in ("kahan", "fast"):
            for pin in (False, True):
                ops1 = bounds.stream_work(one, v, 4, mode, pin)[1]
                opsk = bounds.stream_work(seg, v, 4, mode, pin)[1]
                assert abs(opsk / ops1 - 1) < 0.02, (k, mode, pin, opsk / ops1)
    assert bounds.stream_terms(one) == one.n_items
