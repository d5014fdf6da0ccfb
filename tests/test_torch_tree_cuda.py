"""Kernels B3 (tree level) and X1-X3 (item-rate variants) of graphtpu_torch
on an NVIDIA GPU, against their plain PyTorch versions, B3's column panel
and X3's against the row tiles, and the tree branch of exact SimRank on
the card against the CPU.  Every test needs a card and skips without one.
This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_tree_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.bench import spmv_rate
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.kernels import spmm
from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _graph(v=300, e=3000, seed=0, weighted=False):
    """A hub row of degree v-2, an isolated last row, random edges."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    hub = np.stack([np.zeros(v - 2, np.int64), np.arange(1, v - 1)], 1)
    edges = np.concatenate([edges, hub])
    edges = edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    return gt.build_graph(edges, weights=wts, n_nodes=v)


def _level(dev, m=1000, w=8, n=700, seed=0):
    rng = np.random.default_rng(seed)
    slots = torch.from_numpy(rng.integers(0, n, (m, w)).astype(np.int32)).to(dev)
    wts = torch.from_numpy(rng.random((m, w)).astype(np.float32)).to(dev)
    return slots, wts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("ld,lo,c", [(3072, 1024, 2048), (2051, 3, 2000), (1030, 0, 1030)])
def test_gather_matches_plain(cuda, dtype, w, ld, lo, c):
    """A column block [lo, lo+c) of an [N, ld] table: 16-byte loads when ld
    and lo are multiples of 4, scalar loads otherwise."""
    slots, wts = _level(cuda, w=w)
    x = torch.rand((700, ld), device=cuda).to(dtype)
    table = x[:, lo:lo + c]
    got = spmm.gather_rows_sum(slots, wts, table)
    plain = spmm.gather_rows_sum_plain(slots, wts, table)
    assert got.dtype == torch.float32 and got.shape == (1000, c)
    # the same rounded products added in the same order: bit-equal
    assert torch.equal(got, plain)


def _plan_tree(dev, m=5000, w=8, n=700, seed=0):
    """A two-level tree over an n-row table: level 0 of ragged mini-rows
    (0..W valid slots of one weight, weight-0 pads after them) with its
    compact plan, ten chunks of 512 mini-rows so that the plan's ring
    wraps; then a last level that copies each row (weight 1, weight-0 pads
    at row 0), so that tree_spmm gives level 0's sums.  Returns the tree
    and level 0's slots and weights."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, w + 1, m)
    on = np.arange(w)[None, :] < cnt[:, None]
    slots = np.where(on, rng.integers(0, n, (m, w)), 0).astype(np.int32)
    wts = np.repeat(rng.random((m, 1)), w, 1) + 0.1
    wts = np.where(on, wts, 0).astype(np.float32)
    copy = np.zeros((m, w), np.int32)
    copy[:, 0] = np.arange(m)
    ones = np.zeros((m, w), np.float32)
    ones[:, 0] = 1
    tree = spmm.tree_from_numpy([slots, copy], [wts, ones], w, m, (m, m), device=dev)
    assert tree.layout(0) is not None and tree.layout(0).data.is_cuda
    return tree, tree.levels[0], tree.weights[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ld,lo,c", [(3072, 1024, 2048), (2051, 3, 2000), (1030, 0, 1030),
                                     (1001, 0, 1001)])
def test_gather_panel_matches_row_tiles(cuda, dtype, ld, lo, c):
    """A column block of an [N, ld] table: 16-byte panel copies when the
    row starts allow, element copies and a ragged last slab otherwise; the
    panel's slab-major output read back by the next level."""
    tree, sl, wt = _plan_tree(cuda)
    table = torch.rand((700, ld), device=cuda).to(dtype)[:, lo:lo + c]
    panel = spmm.tree_spmm(tree, table, c)
    rows = spmm.tree_spmm(dataclasses.replace(tree, layouts=()), table, c)
    assert panel.dtype == torch.float32 and panel.shape == (5000, c)
    assert torch.equal(panel, rows)  # the same products in the same order
    assert torch.equal(panel, spmm.gather_rows_sum_plain(sl, wt, table))


@pytest.mark.parametrize("width,lo", [(5000, 2000), (5001, 3)])
def test_gather_panel_writes_into_a_column_block_of_out(cuda, width, lo):
    """tree_spmm's column blocks (512, 512, 76 columns) of a strided table:
    the panel's slabs of each block, and the last level writing its block
    of the result."""
    tree, sl, wt = _plan_tree(cuda)
    x = torch.rand((700, width), device=cuda)[:, lo:lo + 1100]
    got = spmm.tree_spmm(tree, x, 512)
    assert torch.equal(got, spmm.gather_rows_sum_plain(sl, wt, x))
    assert torch.equal(got, spmm.tree_spmm(dataclasses.replace(tree, layouts=()), x, 512))


def test_gather_writes_into_a_column_block_of_out(cuda):
    slots, wts = _level(cuda)
    x = torch.rand((700, 3000), device=cuda)
    out = torch.full((1000, 5000), 7.0, device=cuda)
    spmm.gather_rows_sum(slots, wts, x[:, 1000:2100], out=out[:, 2000:3100])
    assert torch.equal(out[:, 2000:3100], spmm.gather_rows_sum_plain(slots, wts, x[:, 1000:2100]))
    assert (out[:, :2000] == 7).all() and (out[:, 3100:] == 7).all()


def test_gather_rejects_bad_inputs(cuda):
    slots, wts = _level(cuda)
    x = torch.rand((700, 64), device=cuda)
    with pytest.raises(TypeError, match="table"):
        spmm.gather_rows_sum(slots, wts, x.half())
    with pytest.raises(ValueError, match="device"):
        spmm.gather_rows_sum(slots, wts, x.cpu())
    with pytest.raises(ValueError, match="column stride"):
        spmm.gather_rows_sum(slots, wts, x.t())
    with pytest.raises(ValueError, match="column stride"):
        spmm.gather_rows_sum(slots, wts, x, out=torch.empty((64, 1000), device=cuda).t())
    with pytest.raises(TypeError, match="slots"):
        spmm.gather_rows_sum(slots.long(), wts, x)


@pytest.mark.parametrize("width,col_block", [(8, 4096), (4, 384)])
@pytest.mark.parametrize("weighted", [False, True])
def test_tree_spmm_matches_cpu_and_oracle(cuda, weighted, width, col_block):
    g = _graph(weighted=weighted)
    x = np.random.default_rng(1).random((300, 1000)).astype(np.float32)
    tree = spmm.build_reduction_tree(g, width=width, weighted=weighted)
    got = spmm.tree_spmm(tree.to(cuda), torch.from_numpy(x).to(cuda), col_block)
    cpu = spmm.tree_spmm(tree, torch.from_numpy(x), col_block)
    assert torch.equal(got.cpu(), cpu)  # same operations, same order
    oracle = spmm.spmm_oracle(g, x, weighted=weighted)
    assert np.abs(got.cpu().numpy() - oracle).max() <= 1e-5
    assert not got[299].any()


def test_tree_runs_the_panel_where_it_fits(cuda):
    """Every level of the V = 300 tree fits the panel; a 13,000-row level 0
    does not.  tree_spmm runs the panel on each level below the last
    (storing slab-major for the next level, which reads the slabs); it and
    the row tiles alone give the same bits over f32 and bf16 iterates, in
    one column block and in several."""
    g = _graph()
    tree = spmm.build_reduction_tree(g, device=cuda)
    assert all(l is not None for l in tree.layouts) and tree.layout_host_ms > 0
    assert [l.n_table for l in tree.to(cuda).layouts] == [l.n_table for l in tree.layouts]
    rows = dataclasses.replace(tree, layouts=())
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand((300, 700), device=cuda).to(dtype)
        before = spmm.GATHER_LAUNCHES["gather_rows_sum"]
        got = spmm.tree_spmm(tree, x, 512)
        assert spmm.GATHER_LAUNCHES["gather_rows_sum"] - before == 2 * len(tree.levels)
        assert torch.equal(got, spmm.tree_spmm(rows, x, 512))
        assert torch.equal(spmm.tree_spmm(tree, x, 700), spmm.tree_spmm(rows, x, 700))
        assert torch.equal(got, spmm.tree_spmm(tree.to("cpu"), x.cpu(), 512).to(cuda))
    weighted = spmm.build_reduction_tree(_graph(weighted=True), weighted=True, device=cuda)
    assert weighted.layouts[0] is None and weighted.layouts[-1] is not None
    big = gt.build_graph(np.array([[0, 12_999], [1, 2], [2, 3]]), n_nodes=13_000)
    assert spmm.build_reduction_tree(big, device=cuda).layouts[0] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simrank_tree_on_card_matches_cpu(cuda, dtype):
    g = _graph(v=200, e=1500)
    cfg = SimRankConfig(iterations=3)
    tree = spmm.build_reduction_tree(g)
    before = spmm.GATHER_LAUNCHES["gather_rows_sum"]
    got = exact_simrank_spmm(g, cfg, dtype=dtype, impl="tree", col_block=96, device=cuda)
    # iterations x 2 products x ceil(200 / 96) column blocks x levels
    assert spmm.GATHER_LAUNCHES["gather_rows_sum"] - before == 3 * 2 * 3 * len(tree.levels)
    assert got.dtype == dtype
    cpu = exact_simrank_spmm(g, cfg, dtype=dtype, impl="tree", col_block=96, device="cpu")
    dense = exact_simrank(g, cfg, device=cuda)
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), cpu)
        assert (got - dense).abs().max().item() <= 2e-5
    else:
        assert (got.float().cpu() - cpu.float()).abs().max().item() <= 1e-2
        assert (got.float() - dense).abs().max().item() <= 1e-2


def _stream(dev):
    return spmm.build_spmv_stream(_graph(), block_items=64, device=dev)


@pytest.mark.parametrize("c", [1024, 1000])
def test_rate_variants_match_plain(cuda, c):
    st = _stream(cuda)
    x = torch.rand((300, c), device=cuda)
    buf = torch.rand((spmv_rate.N_BUF, c), device=cuda)
    assert torch.equal(spmv_rate.gather_only(st, x), spmv_rate.gather_only_plain(st, x))
    # the plain index_add_ adds in atomic order: 1e-5 of the row's Σ|terms|
    for got, plain in ((spmv_rate.unroll8(st, x), spmv_rate.unroll8_plain(st, x)),
                       (spmv_rate.accumulate_only(st, buf),
                        spmv_rate.accumulate_only_plain(st, buf))):
        assert got.shape == (301, c)
        assert ((got - plain).abs() <= 1e-5 * plain.abs()).all()


@pytest.mark.parametrize("c", [1024, 1000])
def test_x3_panel_matches_plain_and_row_tiles(cuda, c):
    """X3 runs B2's panel over a stream with a sliced layout: within 1e-5
    of the row's Σ|terms| of its plain version, and on lane rows (one lane
    a row, items in order) bit-equal to the row tiles."""
    st = _stream(cuda)
    assert spmv_rate.design("unroll8", st) == "panel"
    rows_st = spmm.row_tiles(st)
    assert spmv_rate.design("unroll8", rows_st) == "rows"
    x = torch.rand((300, c), device=cuda)
    got = spmv_rate.unroll8(st, x)
    plain = spmv_rate.unroll8_plain(st, x)
    rows = spmv_rate.unroll8(rows_st, x)
    assert got.shape == (301, c)
    assert ((got - plain).abs() <= 1e-5 * plain.abs()).all()
    assert torch.equal(got, spmv_rate.unroll8(st, x))  # the same bits on every run
    lane = np.setdiff1d(np.arange(301), st.layout.hub_rows.cpu().numpy())
    lane = torch.as_tensor(lane, device=cuda)
    assert torch.equal(got[lane], rows[lane])
    # V past one panel: the stream carries no layout and X3 runs row tiles
    big = spmm.build_spmv_stream(gt.build_graph(np.array([[0, 12_999], [1, 2]]),
                                                n_nodes=13_000), device=cuda)
    assert spmv_rate.design("unroll8", big) == "rows"


def test_launch_counts(cuda):
    st = _stream(cuda)
    x = torch.rand((300, 64), device=cuda)
    buf = torch.rand((spmv_rate.N_BUF, 64), device=cuda)
    slots, wts = _level(cuda, n=300)
    tree = spmm.build_reduction_tree(_graph(), device=cuda)
    assert tree.layout(0) is not None
    before = dict(spmv_rate.RATE_LAUNCHES)
    g_before = spmm.GATHER_LAUNCHES["gather_rows_sum"]
    spmv_rate.gather_only(st, x)
    spmv_rate.unroll8(st, x)
    spmv_rate.unroll8(st, x)
    spmv_rate.accumulate_only(st, buf)
    spmv_rate.unroll8_plain(st, x)
    spmm.gather_rows_sum(slots, wts, x)
    spmm.tree_spmm(tree, x)  # one column block: a launch per level, panel or row tiles
    spmm.gather_rows_sum_plain(slots, wts, x)
    assert spmv_rate.RATE_LAUNCHES == {
        "gather_only": before["gather_only"] + 1,
        "accumulate_only": before["accumulate_only"] + 1,
        "unroll8": before["unroll8"] + 2,
    }
    assert spmm.GATHER_LAUNCHES["gather_rows_sum"] == g_before + 1 + len(tree.levels)


def test_rate_wrappers_reject_bad_inputs(cuda):
    st = _stream(cuda)
    x = torch.rand((300, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_rate.unroll8(st, torch.rand((64, 300), device=cuda).t())
    with pytest.raises(ValueError, match="device"):
        spmv_rate.gather_only(st.to("cpu"), x)
    with pytest.raises(TypeError, match="float32"):
        spmv_rate.unroll8(st, x.bfloat16())
