"""The packed-lane panel of kernels B1/B2 (``kernels/spmm.py:PackedLayout``)
on the CPU: the layout holds every stream item exactly once, each row of at
most PACK_PIECE items in one lane in stream order and each longer row as
pieces; the entries decode to the items' table rows, hot or cold; rows with
no items are listed; the entry's V limit holds; a float32 walk of the
layout in the kernel's order matches graphtpu's B1 and B2 (Pallas
interpret mode) and, for B2, the plain version's bits on rows of at most
SELL_HUB items; the rule that gives each stream its design; the layout's
ctypes mirror."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.kernels import spmm as jspmm
from graphtpu_torch.bench import generators
from graphtpu_torch.kernels import _build, spmm

torch.set_num_threads(1)

C = 1024  # the Pallas kernels' column quantum
HUB = spmm.SELL_HUB
PIECE = spmm.PACK_PIECE
COLD = spmm.PACK_COLD


def _skewed_edges(scale, n_edges, seed, hub=0, v=None):
    """R-MAT edges on 2^scale rows and, with ``hub``, row 0 joined to
    ``hub`` distinct other rows of ``v``."""
    edges = generators.rmat_graph(scale=scale, n_edges=n_edges, seed=seed)
    if hub:
        nb = 1 + np.random.default_rng(seed).permutation(v - 1)[:hub]
        edges = np.concatenate([edges, np.stack([np.zeros(hub, np.int64), nb], 1)])
    return edges


def _streams(scale=9, n_edges=3000, seed=0, hub=0, v=None, block_items=64):
    v = v or (1 << scale)
    edges = _skewed_edges(scale, n_edges, seed, hub, v)
    ts = spmm.build_spmv_stream(gt.build_graph(edges, n_nodes=v), block_items=block_items)
    js = jspmm.build_spmv_stream(graphtpu.build_graph(edges, n_nodes=v), block_items=block_items)
    return ts, js


def _decode(lay):
    """Per position: (warp, walk index t, lane), its entry and the table row
    the entry names."""
    jb, cp = spmm.SELL_JB, spmm.SELL_CHUNK
    p = np.arange(lay.codes.numel())
    ch, rem = p // cp, p % cp
    w, jj, lane = rem // (32 * jb), (rem // 32) % jb, rem % 32
    code = lay.codes.numpy().view(np.uint16).astype(np.int64)
    hot = lay.hot_rows.numpy()
    row = np.where(code & COLD, code & (COLD - 1), hot[np.minimum(code & (COLD - 1),
                                                                  len(hot) - 1)])
    return w, ch * jb + jj, lane, code, row


def _units(lay):
    """(warp of each unit in walk order, its first walk index, its length)."""
    wu = lay.warp_units.numpy()
    cnt = lay.lane_cnt.numpy().reshape(-1, 32)
    size = cnt.max(1)
    warp = np.repeat(np.arange(spmm.SELL_WARPS), np.diff(wu))
    off = np.cumsum(size) - size
    off -= np.concatenate([[0], np.cumsum(size)])[wu[:-1]][warp]
    return warp, off, size


@pytest.mark.parametrize("scale,n_edges,seed,hub,v,block_items", [
    (9, 3000, 0, 0, None, 64),
    (10, 6000, 1, 700, None, 16),     # a row of 700 items: two pieces or more
    (8, 400, 2, 0, None, 1),          # row V has no items
    (11, 2000, 3, 5000, 6000, 1024),  # a hub of > 32·128 items, rows 2,048.. isolated
])
def test_packed_layout_holds_the_stream(scale, n_edges, seed, hub, v, block_items):
    s, _ = _streams(scale, n_edges, seed, hub, v, block_items)
    lay = spmm.build_packed_layout(s)
    ri = s.row_items.numpy()
    cnt = np.diff(ri)
    n = int(ri[-1])
    item = lay.item.numpy()
    assert item.size == lay.n_chunks * spmm.SELL_CHUNK
    assert np.array_equal(np.sort(item[item >= 0]), np.arange(n))   # each item once

    w, t, lane, _, _ = _decode(lay)
    u_warp, u_off, u_size = _units(lay)
    assert u_size.max() <= PIECE and (u_size >= 1).all()
    # positions past a warp's units are pads
    per_warp = np.bincount(u_warp, weights=u_size, minlength=spmm.SELL_WARPS)
    assert (item[t >= per_warp[w]] == -1).all()
    assert -(-per_warp.max() // spmm.SELL_JB) == lay.n_chunks
    # the warps' walks are near equal: within one unit
    assert per_warp.max() - per_warp.min() <= PIECE

    # each unit lane's segment: its items in stream order at walk indices
    # off .. off + cnt of that lane, pads after them up to the unit's end
    lane_row = lay.lane_row.numpy().reshape(-1, 32)
    lane_cnt = lay.lane_cnt.numpy().reshape(-1, 32)
    by_slot = {}
    for p in np.flatnonzero(item >= 0):
        by_slot[(w[p], t[p], lane[p])] = item[p]
    hub_rows, hp = lay.hub_rows.numpy(), lay.hub_piece.numpy()
    assert np.array_equal(hub_rows, np.flatnonzero(cnt > PIECE))
    assert lay.n_pieces == hp[-1]
    # a long row's items, hot ones first, then cold ones, each in stream order
    cold_item = lay.row_code.numpy().view(np.uint16)[s.slots.numpy()[:n]] >= COLD
    taken = {r: [t for t in range(ri[r], ri[r + 1]) if not cold_item[t]]
             + [t for t in range(ri[r], ri[r + 1]) if cold_item[t]] for r in hub_rows}
    pieces = {}
    seen_rows = set()
    for u in range(len(u_size)):
        for ln in range(32):
            r, k = int(lane_row[u, ln]), int(lane_cnt[u, ln])
            got = [by_slot.get((u_warp[u], u_off[u] + j, ln), -1) for j in range(u_size[u])]
            assert all(g == -1 for g in got[k:])
            if r == -1:
                assert k == 0
                continue
            if r >= 0:                     # a whole row, its last item where the lane flushes
                assert cnt[r] <= PIECE and k == cnt[r]
                assert got[:k] == list(range(ri[r], ri[r + 1]))
                seen_rows.add(r)
            else:                          # a piece of a long row
                assert 1 <= k <= PIECE
                pieces[-2 - r] = got[:k]
    assert seen_rows == set(np.flatnonzero((cnt > 0) & (cnt <= PIECE)))
    assert sorted(pieces) == list(range(lay.n_pieces))
    for h, r in enumerate(hub_rows):
        joined = sum((pieces[q] for q in range(hp[h], hp[h + 1])), [])
        assert joined == taken[r]
        hot = sum(not c for c in cold_item[ri[r]:ri[r + 1]])
        # full pieces of hot items, then of cold ones; no piece mixes them
        for q in range(hp[h], hp[h + 1]):
            kinds = {bool(cold_item[t]) for t in pieces[q]}
            assert len(kinds) == 1
        assert hp[h + 1] - hp[h] == -(-hot // PIECE) - (-(cnt[r] - hot) // PIECE)
    assert np.array_equal(lay.empty_rows.numpy(), np.flatnonzero(cnt == 0))
    if block_items == 1:
        assert cnt[-1] == 0 and lay.empty_rows.numpy()[-1] == s.n_nodes


@pytest.mark.parametrize("hot", [None, 37, 1])
def test_entries_decode_to_their_slots(hot):
    """A hot entry is the panel index of the item's table row, a cold one
    PACK_COLD plus the row; the panel holds the ``hot`` most-read rows
    (ties to the lower row), ascending; each chunk lists its cold rows."""
    s, _ = _streams(8, 1500, 4, block_items=64)
    lay = spmm.build_packed_layout(s, hot=hot)
    v = s.n_nodes
    n = int(s.row_items[-1])
    reads = np.bincount(s.slots[:n].numpy(), minlength=v)
    want = np.sort(sorted(range(v), key=lambda r: (-reads[r], r))[: hot or v])
    assert np.array_equal(lay.hot_rows.numpy(), want)
    _, t, _, code, row = _decode(lay)
    item = lay.item.numpy()
    real = item >= 0
    assert np.array_equal(row[real], s.slots.numpy()[item[real]])
    cold = code >= COLD
    assert np.array_equal(cold[real], ~np.isin(row[real], want))
    assert (code[~real] == 0).all()
    # each chunk lists its distinct cold rows, ascending, for the prefetch
    ch = np.arange(code.size) // spmm.SELL_CHUNK
    beg, listed = lay.cold_beg.numpy(), lay.cold_rows.numpy()
    assert beg[0] == 0 and beg[-1] == len(listed)
    for c in range(lay.n_chunks):
        assert np.array_equal(listed[beg[c]:beg[c + 1]],
                              np.unique(row[(ch == c) & cold & real]))
    row_code = lay.row_code.numpy().view(np.uint16).astype(np.int64)
    assert np.array_equal(row_code[want], np.arange(len(want)))
    cold_rows = np.setdiff1d(np.arange(v), want)
    assert np.array_equal(row_code[cold_rows], COLD + cold_rows)
    if hot is not None:
        assert spmm.hot_share(s, hot) == reads[want].sum() / n
    with pytest.raises(ValueError, match="panel holds"):
        spmm.build_packed_layout(s, hot=v + 1)


def test_entry_limits_v():
    """V up to PACK_MAX_V fits the entry's 14-bit row; one more raises."""
    assert spmm.PACK_MAX_V == 1 << 14
    v = spmm.PACK_MAX_V
    star = np.stack([np.zeros(6000, np.int64), np.arange(v - 6000, v)], 1)
    ok = spmm.build_spmv_stream(gt.build_graph(star, n_nodes=v), block_items=1)
    lay = spmm.build_packed_layout(ok, hot=100)
    _, _, _, code, row = _decode(lay)
    item = lay.item.numpy()
    assert row[item >= 0].max() == v - 1  # the last row, cold
    assert code.max() == COLD + v - 1
    too_many = gt.build_graph(star, n_nodes=v + 1)
    with pytest.raises(ValueError, match="16-bit entry"):
        spmm.build_packed_layout(spmm.build_spmv_stream(too_many, block_items=1))
    with pytest.raises(ValueError, match="uniform seg-1"):
        spmm.build_packed_layout(dataclasses.replace(ok, uniform=False))


def _kahan_merge(s, cp, s2, c2):
    t = s + s2
    bb = t - s
    err = (s - (t - bb)) + (s2 - bb)
    return t, (cp + c2) - err


def _walk(stream, lay, x, mode, table_scale):
    """The packed-lane kernel in float32, in its order: each warp's chunks
    in turn, 32 lanes a position; an entry names a panel or table row; a
    lane adds while its position is below its count; at the unit's end
    every lane flushes (B2 scaled) and takes its next unit; the pieces are
    joined in order (TwoSum for B1) and B2 scales them; rows with no items
    are zeros."""
    f = np.float32
    kahan = mode == "kahan"
    cols = np.arange(x.shape[1])
    w, t, lane, _, trow = _decode(lay)
    lane_row = lay.lane_row.numpy().reshape(-1, 32)
    lane_cnt = lay.lane_cnt.numpy().reshape(-1, 32)
    lane_w = (lay.lane_wts if kahan else lay.lane_scale).numpy().reshape(-1, 32)
    wu = lay.warp_units.numpy()
    out = np.zeros((stream.n_nodes + 1, x.shape[1]), f)
    acc = np.zeros((lay.n_pieces, 2, x.shape[1]), f)
    for warp in range(spmm.SELL_WARPS):
        mine = np.flatnonzero(w == warp)
        order = mine[np.argsort(t[mine], kind="stable")].reshape(-1, 32)  # walk x lane
        u, j = wu[warp], 0
        s, cp = np.zeros((32, x.shape[1]), f), np.zeros((32, x.shape[1]), f)
        for p in order:
            if u >= wu[warp + 1]:
                break
            assert (lane[p] == np.arange(32)).all()
            v = x[trow[p]]
            if table_scale is not None:
                v = np.where(cols[None, :] == trow[p][:, None], f(1), f(table_scale) * v)
            ok = (j < lane_cnt[u])[:, None]
            if kahan:
                y = v * lane_w[u][:, None] - cp
                tt = s + y
                cn = (tt - s) - y
                s, cp = np.where(ok, tt, s), np.where(ok, cn, cp)
            else:
                s = np.where(ok, s + v, s)
            j += 1
            if j == lane_cnt[u].max():
                for ln in range(32):
                    r = lane_row[u, ln]
                    if r >= 0:
                        out[r] = s[ln] if kahan else s[ln] * lane_w[u, ln]
                    elif r < -1:
                        acc[-2 - r] = s[ln], cp[ln]
                s, cp = np.zeros_like(s), np.zeros_like(cp)
                u, j = u + 1, 0
    hp, scale = lay.hub_piece.numpy(), lay.row_scale.numpy()
    for h, r in enumerate(lay.hub_rows.numpy()):
        sh, ch = acc[hp[h]]
        for q in range(hp[h] + 1, hp[h + 1]):
            sh, ch = _kahan_merge(sh, ch, *acc[q]) if kahan else (sh + acc[q][0], ch)
        out[r] = sh if kahan else sh * scale[r]
    return out


def _pallas(js, x, mode, table_scale):
    out = jspmm.spmv_pallas_flat(js, jnp.asarray(x).reshape(-1), x.shape[1], interpret=True,
                                 mode=mode, table_scale=table_scale)
    return np.asarray(out.astype(jnp.float32)).reshape(js.n_nodes + 1, x.shape[1])


@pytest.mark.parametrize("hot", [None, 300])
@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_packed_walk_matches_graphtpu(mode, table_scale, hot):
    """R-MAT on 2,048 rows with a hub row of 4,300 items (9 pieces) among
    4,400 rows; with ``hot`` = 300 most of the reads are cold."""
    v = 4400
    s, js = _streams(11, 2500, 5, hub=4300, v=v, block_items=1024)
    lay = spmm.build_packed_layout(s, hot=hot)
    cnt = np.diff(s.row_items.numpy())
    assert cnt.max() > 32 * HUB and lay.n_pieces >= 9
    x = np.random.default_rng(6).random((v, C)).astype(np.float32)
    got = _walk(s, lay, x, mode, table_scale)
    # f32 sums in another order: 1e-5 absolute on values <= 1
    np.testing.assert_allclose(got, _pallas(js, x, mode, table_scale), atol=1e-5)
    plain = spmm.spmv_plain(s, torch.from_numpy(x), mode, table_scale).numpy()
    if mode == "fast":
        # the plain version's index_add_ also sums each row in stream order
        lane = cnt <= HUB
        assert np.array_equal(got[lane], plain[lane])
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_packed_walk_writes_rows_with_no_items():
    """A stream with empty rows (no dummy item): the walk writes them as
    zeros and every other row as the plain version does."""
    rng = np.random.default_rng(8)
    v, n = 300, 2000
    rows = np.setdiff1d(np.arange(v), [3, 7, 200])
    pos = np.sort(np.concatenate([rows, rng.choice(rows, n - len(rows) - 40),
                                  np.full(40, 5)]))  # row 5: > 32 items
    slots = rng.integers(0, v, n)
    deg = np.bincount(pos, minlength=v + 1).astype(np.float32)
    scales = 1.0 / deg[pos]
    s = spmm.stream_from_numpy(slots, scales, pos, np.ones(n), scales, v, n, 1, True)
    lay = spmm.build_packed_layout(s)
    assert set(lay.empty_rows.tolist()) == {3, 7, 200, v}
    x = rng.random((v, 64)).astype(np.float32)
    for mode in ("kahan", "fast"):
        got = _walk(s, lay, x, mode, 0.6)
        assert (got[[3, 7, 200, v]] == 0).all()
        plain = spmm.spmv_plain(s, torch.from_numpy(x), mode, 0.6).numpy()
        np.testing.assert_allclose(got, plain, atol=1e-6)


def _uniform(v, d, block_items=1):
    """A star of degree d at row 0 (rows 1..d its leaves, the rest
    isolated), unweighted: row 0 holds d of the v - 1 + d items, rows 0..d
    take every read."""
    star = np.stack([np.zeros(d, np.int64), np.arange(1, d + 1)], 1)
    return spmm.build_spmv_stream(gt.build_graph(star, n_nodes=v), block_items=block_items)


@pytest.mark.parametrize("case,want", [
    ("v=11,448, hub", "panel"),
    ("v=11,449, hub", "packed"),
    ("v=16,384, hub", "packed"),
    ("v=16,385, hub", "rows"),
    ("hub share just below", "tiles"),
    ("hub share at the threshold", "packed"),
    ("hot share at the threshold", "packed"),
    ("hot share just below", "rows"),
    ("weighted", "rows"),
    ("seg-2", "rows"),
])
def test_design_rule_packed(case, want):
    if case.startswith("v="):
        v = int(case[2:-5].replace(",", ""))
        s = _uniform(v, v // 2)                 # hub share 1/3, every read on rows 0..v/2
    elif case == "hub share just below":
        s = _uniform(12_001, 3999)
        assert spmm.hub_share(s) < spmm.TILES_HUB_SHARE
    elif case == "hub share at the threshold":
        s = _uniform(12_001, 4000)
        assert spmm.hub_share(s) == spmm.TILES_HUB_SHARE
    elif case.startswith("hot share"):
        # a full star on v rows: row 0 holds v - 1 reads, each leaf one;
        # the panel's H rows take (v - 1 + H - 1) of 2(v - 1) reads
        m = int((spmm.PACK_ROWS - 1) / (2 * spmm.PACK_HOT_SHARE - 1))
        v = m + 1 if case.endswith("threshold") else m + 2
        s = _uniform(v, v - 1)
        share = spmm.hot_share(s)
        assert (share >= spmm.PACK_HOT_SHARE) == case.endswith("threshold")
    elif case == "weighted":
        s = dataclasses.replace(_uniform(12_001, 6000), uniform=False)
    else:
        s = spmm.build_spmv_segments(gt.build_graph(
            np.stack([np.zeros(6000, np.int64), np.arange(1, 6001)], 1), n_nodes=12_001), k=2)
    assert spmm.design_rule(s) == want


def test_packed_stream_design_and_cpu_run():
    """A stream with a packed layout runs "packed" for f32 and bf16 tables
    on the card; ``row_tiles`` drops it; on the CPU the layout changes
    nothing; ``to`` moves it; a stream takes one layout."""
    s, _ = _streams(8, 1200, 9)
    packed = dataclasses.replace(s, packed=spmm.build_packed_layout(s))
    assert spmm.spmv_design(packed) == spmm.spmv_design(packed, torch.bfloat16) == "packed"
    assert spmm.spmv_design(spmm.row_tiles(packed)) == "rows"
    assert spmm.layout_of(packed) is packed.packed and spmm.layout_of(s) is None
    moved = packed.to("cpu")
    assert torch.equal(moved.packed.codes, packed.packed.codes)
    x = torch.rand((s.n_nodes, 16), generator=torch.Generator().manual_seed(0))
    for mode in ("kahan", "fast"):
        assert torch.equal(spmm.spmv(packed, x, mode, 0.6), spmm.spmv(s, x, mode, 0.6))
    both = dataclasses.replace(packed, tiles=spmm.build_tile_plan(s))
    with pytest.raises(ValueError, match="one of"):
        spmm.layout_of(both)


def test_packed_launch_args_follow_the_kernels_struct():
    """The ctypes mirror of ``struct GtPacked`` names the source's fields in
    its order, and ``packed_launch_args`` points each at the layout's
    tensor (B1 the lanes' folded weights, B2 their scales), with scratch for
    each piece's sums (and compensations, for B1)."""
    src = (Path(spmm.__file__).parent / "csrc" / "spmv.cu").read_text()
    body = src[src.index("struct GtPacked {"):src.index("};", src.index("struct GtPacked {"))]
    names = re.findall(r"^\s+(?:const )?\w+\*? (\w+);", body, re.M)
    assert names == [f for f, _ in _build.GtPacked._fields_]
    s, _ = _streams(10, 6000, 1, hub=700)
    lay = spmm.build_packed_layout(s)
    assert lay.n_pieces >= 2  # the row of 700 items
    for kahan in (True, False):
        ref, acc = spmm.packed_launch_args(lay, 5, kahan, "cpu")
        args = ref._obj
        for name in ("codes", "hot_rows", "row_code", "cold_beg", "cold_rows", "lane_row",
                     "lane_cnt", "warp_units", "hub_rows", "hub_piece", "empty_rows"):
            assert (getattr(args, name) or 0) == getattr(lay, name).data_ptr()  # NULL: None
        assert args.lane_w == (lay.lane_wts if kahan else lay.lane_scale).data_ptr()
        assert args.row_w == lay.row_scale.data_ptr()
        assert args.hub_acc == acc.data_ptr()
        assert acc.numel() == (2 if kahan else 1) * lay.n_pieces * 5
        assert (args.n_chunks, args.n_hot, args.n_hub, args.n_pieces, args.n_empty) == (
            lay.n_chunks, lay.hot_rows.numel(), lay.hub_rows.numel(), lay.n_pieces,
            lay.empty_rows.numel())


def test_packed_split_needs_a_card():
    """``bench/packed_split.py`` times the card's kernels: without CUDA it
    raises before it builds anything."""
    from graphtpu_torch.bench import packed_split

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            packed_split.main([])


def test_rmat14_layout():
    """R-MAT 14's packed layout, as PERF.md gives it: 66 chunks at fill
    0.972, 361 pieces of 107 rows, 207 of its 2,112 groups of 8 positions
    (B1's and B2's f32 group) waiting on a cold read; the 11,448 panel rows
    take 99.7% of the reads."""
    s = spmm.build_spmv_stream(generators.rmat14_graph())
    assert spmm.design_rule(s) == "packed"
    assert round(spmm.hot_share(s), 3) == 0.997
    lay = spmm.build_packed_layout(s)
    assert (lay.n_chunks, lay.n_pieces, lay.hub_rows.numel()) == (66, 361, 107)
    item = lay.item.numpy()
    assert round((item >= 0).mean(), 3) == 0.972
    code = lay.codes.numpy().view(np.uint16).reshape(lay.n_chunks, spmm.SELL_WARPS, 2, 8, 32)
    waits = (code >= COLD).any(axis=(3, 4))
    assert (int(waits.sum()), waits.size) == (207, 2112)
