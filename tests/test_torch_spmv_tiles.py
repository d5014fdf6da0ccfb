"""The L2 column tiles of kernels B1/B2 (``kernels/spmm.py:TilePlan``) on
the CPU: the plan holds every stream item exactly once and cuts rows of
more than SELL_HUB items into pieces; a plain walk of the plan in the
kernel's order matches graphtpu's B1 and B2 (Pallas interpret mode) and,
on rows of at most SELL_HUB items, sums in the row tiles' order; the rule
that gives each stream its design; the plan's ctypes mirror."""

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
from graphtpu_torch.kernels import _build, spmm

torch.set_num_threads(1)

C = 1024  # the Pallas kernels' column quantum
HUB = spmm.SELL_HUB


def _edges(v, e, seed, hubs):
    """Random edges among rows [len(hubs), v - 2) (row v - 1 isolated) and
    hub row i of degree hubs[i]."""
    rng = np.random.default_rng(seed)
    lo = len(hubs)
    edges = [lo + rng.integers(0, v - 2 - lo, size=(e, 2))]
    edges += [np.stack([np.full(d, i), lo + rng.choice(v - 2 - lo, d, replace=False)], 1)
              for i, d in enumerate(hubs)]
    edges = np.concatenate(edges)
    return edges[edges[:, 0] != edges[:, 1]]


def _streams(v=400, e=900, seed=0, hubs=(300, 129, 128), weighted=False, block_items=64):
    edges = _edges(v, e, seed, hubs)
    wts = (np.random.default_rng(seed + 1).random(len(edges)) + 0.1).astype(np.float32)
    wts = wts if weighted else None
    tg = gt.build_graph(edges, weights=wts, n_nodes=v)
    jg = graphtpu.build_graph(edges, weights=wts, n_nodes=v)
    ts = spmm.build_spmv_stream(tg, weighted=weighted, block_items=block_items)
    js = jspmm.build_spmv_stream(jg, weighted=weighted, block_items=block_items)
    return tg, ts, js


@pytest.mark.parametrize("seed,hubs,block_items", [
    (0, (300, 129, 128), 64),
    (1, (3 * HUB + 1, 2 * HUB, HUB + 1, HUB), 16),
    (2, (), 64),
    (3, (390,), 1000),      # the pad row V is a hub row too
])
def test_tile_plan_holds_the_stream(seed, hubs, block_items):
    _, s, _ = _streams(seed=seed, hubs=hubs, block_items=block_items)
    if block_items == 1000:
        assert s.row_items[-1] - s.row_items[-2] > HUB
    plan = spmm.build_tile_plan(s)
    ri = s.row_items.numpy()
    cnt = np.diff(ri)
    hub_rows = plan.hub_rows.numpy()
    assert np.array_equal(hub_rows, np.flatnonzero(cnt > HUB))
    hp = plan.hub_piece.numpy()
    p_row, p_beg = plan.piece_row.numpy(), plan.piece_beg.numpy()
    assert plan.n_pieces == hp[-1] == len(p_row) == len(p_beg)
    seen = np.zeros(ri[-1], np.int64)
    for r in np.flatnonzero(cnt <= HUB):  # a warp per row, items in stream order
        seen[ri[r]:ri[r + 1]] += 1
    for h, r in enumerate(hub_rows):
        q = np.arange(hp[h], hp[h + 1])
        assert len(q) == -(-cnt[r] // HUB) and (p_row[q] == r).all()
        assert np.array_equal(p_beg[q], ri[r] + HUB * np.arange(len(q)))
        for b in p_beg[q]:
            seen[b:min(b + HUB, ri[r + 1])] += 1
    assert (seen == 1).all()


def _kahan_merge(s, cp, s2, c2):
    t = s + s2
    bb = t - s
    err = (s - (t - bb)) + (s2 - bb)
    return t, (cp + c2) - err


def _walk(stream, plan, x, mode, table_scale):
    """The tiles' sums in float32, in the kernel's order: a row of at most
    SELL_HUB items over its items in stream order; a hub row's pieces each
    so, joined in piece order (TwoSum for B1); B2 scaled by the row's first
    item's scale."""
    f = np.float32
    kahan = mode == "kahan"
    slots, ri = stream.slots.numpy(), stream.row_items.numpy()
    w = (stream.wts if kahan else stream.raw_wts).numpy()
    scales = stream.scales.numpy()
    weigh = kahan or not stream.uniform
    cols = np.arange(x.shape[1])

    def run(a, b):
        s, c = np.zeros(x.shape[1], f), np.zeros(x.shape[1], f)
        for t in range(a, b):
            v = x[slots[t]]
            if table_scale is not None:
                v = np.where(cols == slots[t], f(1), f(table_scale) * v)
            if weigh:
                v = v * w[t]
            if kahan:
                y = v - c
                tt = s + y
                c = (tt - s) - y
                s = tt
            else:
                s = s + v
        return s, c

    hubs = {int(r): h for h, r in enumerate(plan.hub_rows.numpy())}
    hp, p_beg = plan.hub_piece.numpy(), plan.piece_beg.numpy()
    out = np.zeros((stream.n_nodes + 1, x.shape[1]), f)
    for r in range(stream.n_nodes + 1):
        if r in hubs:
            h = hubs[r]
            parts = [run(b, min(b + HUB, ri[r + 1])) for b in p_beg[hp[h]:hp[h + 1]]]
            s, cp = parts[0]
            for s2, c2 in parts[1:]:
                s, cp = _kahan_merge(s, cp, s2, c2) if kahan else (s + s2, cp)
        else:
            s, _ = run(ri[r], ri[r + 1])
        if not kahan:
            s = s * (scales[ri[r]] if ri[r + 1] > ri[r] else f(0))
        out[r] = s
    return out


def _pallas(js, x, mode, table_scale):
    out = jspmm.spmv_pallas_flat(js, jnp.asarray(x).reshape(-1), x.shape[1], interpret=True,
                                 mode=mode, table_scale=table_scale)
    return np.asarray(out.astype(jnp.float32)).reshape(js.n_nodes + 1, x.shape[1])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_tile_walk_matches_graphtpu(mode, table_scale, weighted):
    v = 300
    _, s, js = _streams(v=v, e=700, seed=5, hubs=(2 * HUB + 7, HUB + 1, HUB),
                        weighted=weighted)
    plan = spmm.build_tile_plan(s)
    assert plan.n_pieces == 5
    x = np.random.default_rng(6).random((v, C)).astype(np.float32)
    got = _walk(s, plan, x, mode, table_scale)
    # f32 sums in another order: 1e-5 absolute on values <= 1
    np.testing.assert_allclose(got, _pallas(js, x, mode, table_scale), atol=1e-5)
    plain = spmm.spmv_plain(s, torch.from_numpy(x), mode, table_scale).numpy()
    lane = np.diff(s.row_items.numpy()) <= HUB
    if mode == "fast":
        # the plain version's index_add_ also sums each row in stream order
        assert np.array_equal(got[lane], plain[lane])
    np.testing.assert_allclose(got, plain, atol=1e-5)


def _uniform(v, d=1, block_items=1):
    """A star of degree d at row 0 (rows 1..d its leaves, the rest
    isolated), unweighted: row 0 holds d of the v - 1 + d items."""
    star = np.stack([np.zeros(d, np.int64), np.arange(1, d + 1)], 1)
    return spmm.build_spmv_stream(gt.build_graph(star, n_nodes=v), block_items=block_items)


@pytest.mark.parametrize("case,want", [
    ("v=11,448", "panel"),
    ("v=11,449", "tiles"),
    ("v=65,535", "tiles"),
    ("v=65,536", "tiles"),
    ("hub share just below", "tiles"),
    ("hub share at the threshold", "packed"),
    ("hub share at the threshold, reads past the panel", "rows"),
    ("seg-2", "rows"),
    ("weighted", "tiles"),
    ("weighted, hub share above", "rows"),
])
def test_design_rule(case, want):
    if case.startswith("v="):
        s = _uniform(int(case[2:].replace(",", "")))
    elif case == "hub share just below":
        s = _uniform(12_001, 3999)      # 3,999 / 15,999 items on the hub row
        assert spmm.hub_share(s) < spmm.TILES_HUB_SHARE
    elif case == "hub share at the threshold":
        s = _uniform(12_001, 4000)      # 4,000 / 16,000
        assert spmm.hub_share(s) == spmm.TILES_HUB_SHARE
    elif case == "hub share at the threshold, reads past the panel":
        s = _uniform(60_001, 20_000)    # 20,000 / 80,000; the packed panel takes 64% of reads
        assert spmm.hub_share(s) == spmm.TILES_HUB_SHARE
        assert spmm.hot_share(s) < spmm.PACK_HOT_SHARE
    elif case == "seg-2":
        s = spmm.build_spmv_segments(_streams()[0], k=2)
    else:
        hubs = (300,) if case == "weighted" else (2000,)
        s = _streams(v=2400, e=300, hubs=hubs, weighted=True)[1]
    assert spmm.design_rule(s) == want


def test_tile_plan_runs_f32_only():
    """A stream with a tile plan runs the tiles for f32 tables and row tiles
    for bf16 ones; on the CPU the plan changes nothing."""
    _, s, _ = _streams()
    tiled = dataclasses.replace(s, tiles=spmm.build_tile_plan(s))
    assert spmm.spmv_design(tiled) == "tiles"
    assert spmm.spmv_design(tiled, torch.bfloat16) == "rows"
    assert spmm.spmv_design(spmm.row_tiles(tiled)) == "rows"
    x = torch.rand((400, 8), generator=torch.Generator().manual_seed(0))
    for mode in ("kahan", "fast"):
        assert torch.equal(spmm.spmv(tiled, x, mode, 0.6), spmm.spmv(s, x, mode, 0.6))
    with pytest.raises(ValueError, match="seg-1"):
        spmm.build_tile_plan(spmm.build_spmv_segments(_streams()[0], k=2))


def test_tiles_launch_args_follow_the_kernels_struct():
    """The ctypes mirror of ``struct GtTiles`` names the source's fields in
    its order, and ``tiles_launch_args`` points each at the plan's tensor,
    with scratch for each piece's sums (and compensations, for B1)."""
    src = (Path(spmm.__file__).parent / "csrc" / "spmv.cu").read_text()
    body = src[src.index("struct GtTiles {"):src.index("};", src.index("struct GtTiles {"))]
    names = re.findall(r"^\s+(?:const )?\w+\*? (\w+);", body, re.M)
    assert names == [f for f, _ in _build.GtTiles._fields_]
    _, s, _ = _streams()
    plan = spmm.build_tile_plan(s)
    for kahan in (True, False):
        ref, acc = spmm.tiles_launch_args(plan, 5, kahan, "cpu")
        args = ref._obj
        for name in ("hub_rows", "hub_piece", "piece_row", "piece_beg"):
            assert getattr(args, name) == getattr(plan, name).data_ptr()
        assert args.acc == acc.data_ptr()
        assert acc.numel() == (2 if kahan else 1) * plan.n_pieces * 5
        assert (args.n_hub, args.n_pieces, args.hub) == (plan.hub_rows.numel(), plan.n_pieces, HUB)
