"""The sliced (SELL-32-σ) layout kernels B1/B2 walk, on the CPU: built from
random item streams, it must hold every stream item exactly once in the
order each lane walks, give every output row one lane (or, for hub rows, a
warp), name each lane's first item, and sum to the float64 oracle."""

import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import graphtpu_torch as gt
from graphtpu_torch.bench import generators
from graphtpu_torch.kernels import _build, spmm

torch.set_num_threads(1)


def _graph(seed, v, n_edges, hub_degree, weighted):
    """Random edges among rows [0, v - 3) (the last three rows isolated),
    plus one hub row 0 of ``hub_degree`` distinct neighbours."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v - 3, size=(n_edges, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    hub = np.stack([np.zeros(hub_degree, np.int64),
                    1 + rng.permutation(v - 4)[:hub_degree]], 1)
    edges = np.concatenate([edges, hub])
    wts = (rng.random(len(edges)) + 0.1).astype(np.float32) if weighted else None
    return gt.build_graph(edges, weights=wts, n_nodes=v)


def _stream(g, k=1, weighted=False):
    return spmm.build_spmv_segments(g, weighted=weighted, k=k, block_items=64)


def _positions(lay):
    """Per position: (unit, lane, j) from the chunk order of the layout."""
    jb, cp = spmm.SELL_JB, spmm.SELL_CHUNK
    p = np.arange(lay.item.numel())
    c, rem = p // cp, p % cp
    w, jj, lane = rem // (32 * jb), (rem // 32) % jb, rem % 32
    ss_chunks = lay.ss_chunks.numpy()
    chunk_ss = np.repeat(np.arange(len(ss_chunks)), ss_chunks)
    first = np.cumsum(ss_chunks) - ss_chunks
    unit = chunk_ss[c] * spmm.SELL_WARPS + w
    j = (c - first[chunk_ss[c]]) * jb + jj
    return unit, lane, j


cases = st.tuples(
    st.integers(0, 2**31 - 1),          # seed
    st.integers(12, 160),               # V
    st.integers(0, 900),                # random edges
    st.integers(5, 8),                  # hub degree: over the threshold below
    st.sampled_from([4, 6]),            # hub threshold
    st.sampled_from([8, 64, 4096]),     # sort window
)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(cases)
def test_layout_holds_the_stream(case):
    seed, v, n_edges, hub_degree, hub, sigma = case
    g = _graph(seed, v, n_edges, hub_degree, False)
    s = _stream(g)
    lay = spmm.build_sell_layout(s, hub=hub, sigma=sigma)
    row_items = s.row_items.numpy()
    cnt = np.diff(row_items)
    n_rows = v + 1
    item = lay.item.numpy()
    unit, lane, j = _positions(lay)
    lane_row = lay.lane_row.numpy().reshape(-1, 32)
    lane_cnt = lay.lane_cnt.numpy().reshape(-1, 32)
    unit_hub = lay.unit_hub.numpy()

    # every stream item exactly once, with its slot; every item of a row
    # has the row's weight and scale
    real = item >= 0
    assert np.array_equal(np.sort(item[real]), np.arange(s.slots.numel()))
    assert np.array_equal(real, j < lane_cnt[unit, lane])
    slots = lay.slots.numpy()
    assert np.array_equal(slots[real], s.slots.numpy()[item[real]])
    assert not slots[~real].any()
    rows_of = np.repeat(np.arange(n_rows), cnt)
    assert np.array_equal(lay.row_wts.numpy()[rows_of], s.wts.numpy())
    assert np.array_equal(lay.row_scale.numpy()[rows_of], s.scales.numpy())
    assert not lay.row_wts.numpy()[cnt == 0].any()

    # a lane walks its row's items in stream order; a hub piece's lanes
    # take its items lane-strided
    pos_row = lane_row[unit, lane]
    lane_units = unit_hub[unit] < 0
    sel = real & lane_units
    assert np.array_equal(item[sel], row_items[pos_row[sel]] + j[sel])
    assert np.array_equal(pos_row[real], np.searchsorted(row_items, item[real], "right") - 1)
    _assert_lane_base(lay)

    # lane counts and the row permutation: every row once, hub rows apart
    hubs = lay.hub_rows.numpy()
    assert np.array_equal(hubs, np.flatnonzero(cnt > hub))
    lane_rows = lane_row[unit_hub < 0].reshape(-1)
    lane_cnts = lane_cnt[unit_hub < 0].reshape(-1)
    assert np.array_equal(np.sort(np.concatenate([lane_rows[lane_rows >= 0], hubs])),
                          np.arange(n_rows))
    assert np.array_equal(lane_cnts[lane_rows >= 0], cnt[lane_rows[lane_rows >= 0]])
    assert not lane_cnts[lane_rows < 0].any()
    pieces = lay.hub_piece.numpy()
    for h, r in enumerate(hubs):
        mine = np.isin(unit_hub, np.arange(pieces[h], pieces[h + 1]))
        assert (lane_row[mine] == r).all()
        assert lane_cnt[mine].sum() == cnt[r]
        assert (lane_cnt[mine] <= -(-32 * hub // 32)).all()
    assert lay.n_pieces == pieces[-1] == (unit_hub >= 0).sum()

    # a float64 mean over the layout's own order equals the oracle (rows of
    # weight 0, the isolated rows' dummies and the pads, are zero rows)
    x = np.random.default_rng(seed + 1).random((v, 3))
    ok = real & (lay.row_wts.numpy()[pos_row] != 0)
    num = np.zeros((n_rows, 3))
    den = np.zeros(n_rows)
    np.add.at(num, pos_row[ok], x[slots[ok].astype(np.int64)])
    np.add.at(den, pos_row[ok], 1.0)
    got = np.where(den[:v, None] > 0, num[:v] / np.maximum(den[:v, None], 1e-300), 0.0)
    np.testing.assert_allclose(got, spmm.spmm_oracle(g, x), rtol=0, atol=1e-12)


def _assert_lane_base(lay):
    """Item j of a lane is lane_base + j (lane rows) or lane_base + 32·j
    (hub pieces) at every non-pad position; lanes with no item have 0."""
    unit, lane, j = _positions(lay)
    item = lay.item.numpy()
    base = lay.lane_base.numpy().reshape(-1, 32)
    step = np.where(lay.unit_hub.numpy() >= 0, 32, 1)
    real = item >= 0
    assert np.array_equal(item[real], (base[unit, lane] + step[unit] * j)[real])
    assert not base[lay.lane_cnt.numpy().reshape(-1, 32) == 0].any()


def _star_plus_random(hub_degree=3 * 32 * spmm.SELL_HUB + 100, v=13_000):
    """Random edges and one row of ``hub_degree`` > 32·SELL_HUB items, so
    that it is cut into several hub pieces."""
    rng = np.random.default_rng(7)
    edges = rng.integers(1, v, size=(20_000, 2))
    hub = np.stack([np.zeros(hub_degree, np.int64), 1 + rng.permutation(v - 1)[:hub_degree]], 1)
    return gt.build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]), n_nodes=v)


@pytest.mark.parametrize("graph", ["blog", "multi_piece_hub"])
def test_lane_base_gives_each_lanes_items(graph):
    g = generators.blog_shaped_graph() if graph == "blog" else _star_plus_random()
    lay = spmm.build_sell_layout(spmm.build_spmv_stream(g))
    assert lay.lane_base.dtype == torch.int32
    assert lay.lane_base.shape == lay.lane_row.shape
    if graph == "multi_piece_hub":
        assert lay.hub_piece[1].item() - lay.hub_piece[0].item() == 4
    _assert_lane_base(lay)


def test_launch_args_follow_the_kernels_struct():
    """The ctypes mirror of ``struct GtSell`` names the header's fields in its
    order, and ``sell_launch_args`` points each at the layout's tensor (B1
    and X2 read the rows' folded weights, B2, X1 and X3 their scales)."""
    header = (Path(spmm.__file__).parent / "csrc" / "panel.cuh").read_text()
    body = header[header.index("struct GtSell {"):header.index("};", header.index("struct GtSell {"))]
    names = re.findall(r"^\s+(?:const )?\w+\*? (\w+);", body, re.M)
    assert names == [f for f, _ in _build.GtSell._fields_]
    g = _graph(3, 60, 300, 8, False)
    lay = spmm.build_sell_layout(_stream(g), 6, 16)
    for kahan, w in ((True, lay.row_wts), (False, lay.row_scale)):
        ref, hub_acc = spmm.sell_launch_args(lay, 5, kahan, "cpu")
        args = ref._obj
        for name in ("slots", "lane_row", "lane_cnt", "lane_base", "unit_hub", "ss_chunks",
                     "hub_rows", "hub_piece"):
            assert getattr(args, name) == getattr(lay, name).data_ptr()
        assert args.row_w == w.data_ptr() and args.hub_acc == hub_acc.data_ptr()
        assert hub_acc.numel() == (2 if kahan else 1) * lay.n_pieces * 5
        assert (args.n_chunks, args.n_pieces) == (lay.n_chunks, lay.n_pieces)


def test_compact_only_for_unweighted_single_rows():
    """The panel's layout holds 16-bit entries and one weight per row: a
    uniform seg-1 stream and an unweighted seg-2 stream (its coefficients
    masks of one value a row) have one, weighted streams do not."""
    g = _graph(3, 60, 300, 8, False)
    lay = spmm.build_sell_layout(_stream(g), 6, 16)
    assert lay.slots.dtype == torch.int16
    assert spmm.runs_panel(_stream(g))
    assert spmm.runs_panel(_stream(g, 2))
    assert spmm.build_sell_layout(_stream(g, 2), 6, 16).slots.dtype == torch.int16
    gw = _graph(3, 60, 300, 8, True)
    assert not spmm.runs_panel(_stream(gw, 1, True))
    assert not spmm.runs_panel(_stream(gw, 2, True))
    for s in (_stream(gw, 2, True), _stream(gw, 1, True)):
        with pytest.raises(ValueError, match="uniform seg-1"):
            spmm.build_sell_layout(s)


@pytest.mark.parametrize("v,want", [
    (10_496, True),     # blog-shaped: the 16-byte slab fits
    (11_448, True),     # the largest V that fits
    (11_449, False),
    (16_384, False),    # R-MAT: row tiles
])
def test_launch_shape(v, want):
    assert spmm.sell_fits(v) == want
    s = spmm.build_spmv_stream(gt.build_graph(np.array([[0, 1], [2, 3]]), n_nodes=v))
    assert spmm.runs_panel(s) == want


def test_stream_builds_a_layout_only_where_the_panel_fits():
    """Streams get their layout on the card only; on the CPU the plain
    version runs and a layout changes nothing."""
    small = _graph(0, 40, 200, 8, False)
    s = spmm.build_spmv_stream(small)
    assert s.layout is None and s.to("cpu").layout is None
    assert spmm.runs_panel(s)
    assert not spmm.runs_panel(spmm.build_spmv_segments(small, k=3))  # no kernel takes seg_k 3
    x = torch.rand((40, 4), generator=torch.Generator().manual_seed(0))
    laid = spmm.with_layout(s, spmm.build_sell_layout(s))
    assert torch.equal(spmm.spmv(laid, x, "kahan"), spmm.spmv(s, x, "kahan"))


# a layout, the stream it is put on (seg_k, weighted) and what its refusal names
_REFUSALS = {
    "sliced on weighted seg-2": ("sliced seg-2", (2, True), "mask-uniform"),
    "packed on seg-2": ("packed", (2, False), "uniform seg-1"),
    "packed on weighted": ("packed", (1, True), "uniform seg-1"),
    "tiles on seg-2": ("tiles", (2, False), "seg-1"),
}
_DESIGN_OF = {"sliced": "panel", "packed": "packed", "tiles": "tiles"}


@pytest.mark.parametrize("case", ["replaces", "row_tiles", "to", "not a layout", *_REFUSALS])
def test_with_layout(case):
    """``with_layout`` puts one layout on a stream in place of the one it
    had, and no other object; ``row_tiles`` drops it; ``to`` moves it; each
    design refuses a stream it does not take, in ``with_layout`` and at the
    launch (a stream edited after the attach)."""
    g, gw = _graph(3, 60, 300, 8, False), _graph(3, 60, 300, 8, True)
    s = _stream(g)
    lays = {"sliced": spmm.build_sell_layout(s), "sliced seg-2": spmm.build_sell_layout(_stream(g, 2)),
            "packed": spmm.build_packed_layout(s), "tiles": spmm.build_tile_plan(s)}
    if case == "not a layout":
        with pytest.raises(TypeError, match="SellLayout, PackedLayout or TilePlan"):
            spmm.with_layout(s, spmm.build_gather_layout(np.zeros((4, 2), np.int32),
                                                         np.ones((4, 2), np.float32)))
        return
    if case in _REFUSALS:
        name, (k, weighted), what = _REFUSALS[case]
        bad = _stream(gw if weighted else g, k, weighted)
        with pytest.raises(ValueError, match=what):
            spmm.with_layout(bad, lays[name])
        edited = dataclasses.replace(bad, layout=lays[name])
        with pytest.raises(ValueError, match=what):
            spmm._spmv_cuda(edited, torch.zeros((g.n_nodes, 4)), "kahan", None)
        return
    for a, b in itertools.permutations(_DESIGN_OF, 2):
        laid = spmm.with_layout(spmm.with_layout(s, lays[a]), lays[b])
        if case == "replaces":
            assert laid.layout is lays[b] and spmm.spmv_design(laid) == _DESIGN_OF[b]
        elif case == "row_tiles":
            assert spmm.row_tiles(laid).layout is None
            assert spmm.spmv_design(spmm.row_tiles(laid)) == "rows"
        else:
            moved = laid.to("cpu").layout
            assert type(moved) is type(lays[b]) and moved is not lays[b]
            for f in dataclasses.fields(moved):
                want, got = getattr(lays[b], f.name), getattr(moved, f.name)
                assert torch.equal(got, want) if isinstance(want, torch.Tensor) else got == want
