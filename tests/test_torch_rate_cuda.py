"""Kernels X1 and X2 of the item-rate probe on an NVIDIA GPU: on B2's column
panel (a stream with a sliced layout) against their plain PyTorch versions
and the row tiles, and the row tiles where no panel fits.  Every test
needs a card and skips without one.  This file imports neither
jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_rate_cuda.py
"""


import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.bench import spmv_rate
from graphtpu_torch.kernels import spmm

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

V = 10_000
TOL_RATE = 1e-5  # X2 vs plain or a float64 sum, relative to the row's sum of |terms| (all >= 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _stream(dev, block_items):
    """V = 10,000: random edges among the first V - 3 rows (the last three
    isolated: a dummy item each) and a hub row 0 of 9,001 items, three
    pieces of 32·SELL_HUB; 29-30 chunks, so the ring of three stages wraps.
    Row V takes the pads: none at block_items = 1 (a lane row with no
    items), 43 at 64 (a lane row), 363 at 1,024 (a hub row)."""
    rng = np.random.default_rng(0)
    edges = rng.integers(0, V - 3, size=(40_000, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    hub = np.stack([np.zeros(9_000, np.int64), 1 + rng.permutation(V - 4)[:9_000]], 1)
    g = gt.build_graph(np.concatenate([edges, hub]), n_nodes=V)
    st = spmm.build_spmv_stream(g, block_items=block_items, device=dev)
    assert isinstance(st.layout, spmm.SellLayout) and st.layout.n_chunks > spmm.SELL_STAGES
    assert st.layout.n_pieces >= 3
    return st


def _lane_rows(st, dev):
    lane = np.setdiff1d(np.arange(V + 1), st.layout.hub_rows.cpu().numpy())
    return torch.as_tensor(lane, device=dev)


@pytest.mark.parametrize("c", [1024, 1000])
@pytest.mark.parametrize("block_items", [1, 64, 1024])
def test_x1_panel_equals_plain_and_row_tiles(cuda, block_items, c):
    """A max is exact: the panel, the row tiles and the plain version give
    the same bits, hub rows, isolated rows and the pad row V included; a
    row with no items is 0."""
    st = _stream(cuda, block_items)
    rows_st = spmm.row_tiles(st)
    assert spmv_rate.design("gather_only", st) == "panel"
    assert spmv_rate.design("gather_only", rows_st) == "rows"
    x = torch.rand((V, c), device=cuda)
    got = spmv_rate.gather_only(st, x)
    assert got.shape == (V + 1, c) and bool(torch.isfinite(got).all())
    assert torch.equal(got, spmv_rate.gather_only_plain(st, x))
    assert torch.equal(got, spmv_rate.gather_only(rows_st, x))
    assert torch.equal(got, spmv_rate.gather_only(st, x))  # the same bits on every run
    if block_items == 1:
        assert not got[V].any()
    assert torch.equal(got[V - 1], x[0])  # an isolated row's dummy item reads row 0


def _x2_float64(st, buf):
    """X2's function summed in float64: Σ_{t in r} wts[t]·buf[t mod 16]."""
    t = torch.arange(st.slots.numel(), device=buf.device)
    terms = st.wts.double()[:, None] * buf.double()[t % spmv_rate.N_BUF]
    out = torch.zeros((V + 1, buf.shape[1]), dtype=torch.float64, device=buf.device)
    return out.index_add_(0, st.pos.long(), terms)


@pytest.mark.parametrize("c", [1024, 1000])
@pytest.mark.parametrize("block_items", [1, 64, 1024])
def test_x2_panel_matches_plain_and_row_tiles(cuda, block_items, c):
    """X2 on the panel: within TOL_RATE of the row's Σ|terms| of a float64
    sum everywhere (the 9,001-item hub row included, whose f32 sum in item
    order, as plain and the row tiles take it, is not), and of its plain
    version on lane rows; there (one lane a row, items in order, the row's
    folded weight equal to each item's) bit-equal to the row tiles."""
    st = _stream(cuda, block_items)
    rows_st = spmm.row_tiles(st)
    assert spmv_rate.design("accumulate_only", st) == "panel"
    buf = torch.rand((spmv_rate.N_BUF, c), device=cuda)
    got = spmv_rate.accumulate_only(st, buf)
    plain = spmv_rate.accumulate_only_plain(st, buf)
    rows = spmv_rate.accumulate_only(rows_st, buf)
    assert got.shape == (V + 1, c) and bool(torch.isfinite(got).all())
    ref = _x2_float64(st, buf)
    assert bool(((got.double() - ref).abs() <= TOL_RATE * ref).all())
    lane = _lane_rows(st, cuda)
    assert bool(((got[lane] - plain[lane]).abs() <= TOL_RATE * plain[lane]).all())
    assert torch.equal(got[lane], rows[lane])
    assert torch.equal(got, spmv_rate.accumulate_only(st, buf))
    assert not got[V - 1].any()  # an isolated row's dummy item has weight 0


@pytest.mark.parametrize("c", [1024, 1000])
def test_x1_x2_row_tiles_where_no_panel_fits(cuda, c):
    """V = 13,000 is past one block's shared memory: the stream carries no
    layout and X1 and X2 run row tiles, X1 equal to its plain version and
    X2 within TOL_RATE of it."""
    rng = np.random.default_rng(1)
    v = 13_000
    edges = rng.integers(0, v, size=(40_000, 2))
    hub = np.stack([np.zeros(500, np.int64), 1 + rng.permutation(v - 1)[:500]], 1)
    g = gt.build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]), n_nodes=v)
    st = spmm.build_spmv_stream(g, device=cuda)
    assert not isinstance(st.layout, spmm.SellLayout)
    assert spmv_rate.design("accumulate_only", st) == "rows"
    x = torch.rand((v, c), device=cuda)
    assert torch.equal(spmv_rate.gather_only(st, x), spmv_rate.gather_only_plain(st, x))
    buf = torch.rand((spmv_rate.N_BUF, c), device=cuda)
    got = spmv_rate.accumulate_only(st, buf)
    plain = spmv_rate.accumulate_only_plain(st, buf)
    assert bool(((got - plain).abs() <= TOL_RATE * plain).all())


def test_rate_launch_counts_by_design(cuda):
    st = _stream(cuda, 64)
    rows_st = spmm.row_tiles(st)
    x = torch.rand((V, 64), device=cuda)
    buf = torch.rand((spmv_rate.N_BUF, 64), device=cuda)
    before = dict(spmv_rate.RATE_LAUNCHES)
    for s in (st, rows_st):
        spmv_rate.gather_only(s, x)
        spmv_rate.accumulate_only(s, buf)
    spmv_rate.gather_only_plain(st, x)
    spmv_rate.accumulate_only_plain(st, buf)
    assert spmv_rate.RATE_LAUNCHES == dict(before, gather_only=before["gather_only"] + 2,
                                           accumulate_only=before["accumulate_only"] + 2)


def test_panel_wrappers_check_the_layouts_device(cuda):
    st = _stream(cuda, 64)
    moved = spmm.with_layout(st, st.layout.to("cpu"))
    with pytest.raises(ValueError, match="device"):
        spmv_rate.gather_only(moved, torch.rand((V, 64), device=cuda))
    with pytest.raises(ValueError, match="device"):
        spmv_rate.accumulate_only(moved, torch.rand((spmv_rate.N_BUF, 64), device=cuda))


def test_x2_over_a_layout_past_the_panel(cuda):
    """X2 reads no panel, so it runs over R-MAT 14's sliced layout (V =
    16,384, past the panel's 11,448 rows): the same bits as the row tiles
    on lane rows, twice; every row within two f32 sums' error bound of its
    plain version, 2·(n - 1)·2^-24·Σ|terms| for a row of n items (R-MAT's
    rows of up to 4,086 items, summed plainly in two orders, differ by more
    than TOL_RATE's 1e-5)."""
    from graphtpu_torch.bench import generators

    st = spmm.build_spmv_stream(generators.rmat14_graph(), device=cuda)
    assert not spmm.sell_fits(st.n_nodes)
    laid = spmm.with_layout(st, spmm.build_sell_layout(st))
    assert spmv_rate.design("accumulate_only", laid) == "panel"
    buf = torch.rand((spmv_rate.N_BUF, 264), generator=torch.Generator().manual_seed(23))
    buf = buf.to(cuda)
    got = spmv_rate.accumulate_only(laid, buf)
    assert torch.equal(got, spmv_rate.accumulate_only(laid, buf))
    plain = spmv_rate.accumulate_only_plain(laid, buf)
    n = torch.diff(laid.row_items).clamp(min=2).double()[:, None]
    assert bool(((got - plain).abs().double() <= 2 * (n - 1) * 2.0**-24 * plain.double()).all())
    lane = np.setdiff1d(np.arange(st.n_nodes + 1), laid.layout.hub_rows.cpu().numpy())
    lane = torch.as_tensor(lane, device=cuda)
    rows = spmv_rate.accumulate_only(spmm.row_tiles(st), buf)
    assert torch.equal(got[lane], rows[lane])
