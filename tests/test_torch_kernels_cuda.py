"""Kernels B1/B2 of graphtpu_torch on an NVIDIA GPU, against their plain
PyTorch version and the float64 oracle, and the transpose between an exact
SimRank iteration's two products (``kernels/transpose.py``) against
``x.t().contiguous()``.  Every test needs a card and skips
without one.  This file imports neither jax nor graphtpu, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""


import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.io.simfile import read_sim_file
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.kernels import spmm, transpose
from graphtpu_torch.simrank import exact
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


def _pinned(x, c):
    t = c * np.asarray(x, np.float64)
    n = min(t.shape)
    t[np.arange(n), np.arange(n)] = 1.0
    return t


def _bf16_ulp(a):
    a = np.abs(a)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-38))) - 7), 0.0)


@pytest.mark.parametrize("width", [1024, 1000])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_kernel_matches_plain_and_oracle(cuda, mode, table_scale, k, width):
    g = _graph()
    plan = spmm.build_spmv_segments(g, k=k, block_items=64, device=cuda)
    x = np.random.default_rng(1).random((300, width)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    got = spmm.spmv(plan, xt, mode, table_scale)
    torch.cuda.synchronize()
    plain = spmm.spmv_plain(plan, xt, mode, table_scale)
    assert got.shape == (301, width) and got.dtype == torch.float32
    # f32 sums in another order: 1e-5 absolute on values <= 1
    assert (got - plain).abs().max().item() <= 1e-5
    table = x if table_scale is None else _pinned(x, table_scale)
    oracle = spmm.spmm_oracle(g, table)
    assert np.abs(got[:300].cpu().numpy() - oracle).max() <= 1e-5
    assert not got[299:].any()


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_kernel_weighted(cuda, mode):
    g = _graph(weighted=True)
    plan = spmm.build_spmv_stream(g, weighted=True, device=cuda)
    x = np.random.default_rng(2).random((300, 1030)).astype(np.float32)
    got = spmm.spmv(plan, torch.from_numpy(x).to(cuda), mode, 0.6)
    oracle = spmm.spmm_oracle(g, _pinned(x, 0.6), weighted=True)
    assert np.abs(got[:300].cpu().numpy() - oracle).max() <= 1e-5


@pytest.mark.parametrize("width", [1024, 1000])
@pytest.mark.parametrize("k", [1, 2])
def test_kernel_fast_bf16(cuda, k, width):
    g = _graph()
    plan = spmm.build_spmv_segments(g, k=k, device=cuda)
    xb = torch.from_numpy(
        np.random.default_rng(3).random((300, width)).astype(np.float32)
    ).to(cuda).bfloat16()
    got = spmm.spmv(plan, xb, "fast", 0.6)
    assert got.dtype == torch.bfloat16
    plain = spmm.spmv_plain(plan, xb, "fast", 0.6).float().cpu().numpy()
    got = got.float().cpu().numpy()
    assert (np.abs(got - plain) <= _bf16_ulp(np.maximum(abs(got), abs(plain)))).all()
    oracle = spmm.spmm_oracle(g, _pinned(xb.float().cpu().numpy(), 0.6))
    assert (np.abs(got[:300] - oracle) <= _bf16_ulp(oracle)).all()


@pytest.mark.parametrize("d", [20_000, 11_000])
def test_kahan_hub_beats_plain_sum(cuda, d):
    """A row of degree d over equal values per column: a sequential f32 sum
    of its terms in item order misses the float64 oracle by more than 1e-5,
    B1 (Kahan) does not.  At d = 20,000 the kernels run row tiles; at
    d = 11,000 the column panel (a warp per hub row), where B2 stays within
    1e-5 as well."""
    width = 1000
    star = np.stack([np.zeros(d, np.int64), np.arange(1, d + 1)], 1)
    g = gt.build_graph(star, n_nodes=d + 1)
    vals = (1 + np.random.default_rng(0).random(width)).astype(np.float32)
    x = torch.from_numpy(np.broadcast_to(vals, (d + 1, width)).copy()).to(cuda)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert (spmm.spmv_design(plan) == "panel") == (d == 11_000)
    oracle = spmm.spmm_oracle(g, x.cpu().numpy(), rows=[0])[0]
    kahan = spmm.spmv(plan, x, "kahan")[0].cpu().numpy()
    lo, hi = plan.row_items[:2].tolist()
    terms = plan.wts[lo:hi].cpu().numpy()[:, None] * x[plan.slots[lo:hi].long()].cpu().numpy()
    seq = np.cumsum(terms.astype(np.float32), axis=0, dtype=np.float32)[-1]
    assert np.abs(kahan - oracle).max() <= 1e-5
    assert np.abs(seq - oracle).max() > 1e-5
    if spmm.spmv_design(plan) == "panel":
        fast = spmm.spmv(plan, x, "fast")[0].cpu().numpy()
        assert np.abs(fast - oracle).max() <= 1e-5


def test_launch_counts(cuda):
    g = _graph()
    plan = spmm.build_spmv_stream(g, device=cuda)
    x = torch.rand((300, 64), device=cuda)
    before = dict(spmm.SPMV_LAUNCHES)
    spmm.spmv(plan, x, "kahan")
    spmm.spmv(plan, x, "fast", 0.6)
    spmm.spmv(plan, x.bfloat16(), "fast")
    spmm.spmv_plain(plan, x, "kahan")
    assert spmm.SPMV_LAUNCHES["kahan"] == before["kahan"] + 1
    assert spmm.SPMV_LAUNCHES["fast"] == before["fast"] + 2


def test_wrapper_rejects_bad_inputs(cuda):
    g = _graph()
    plan = spmm.build_spmv_stream(g, device=cuda)
    x = torch.rand((300, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmv(plan, x.t(), "kahan")
    with pytest.raises(ValueError, match="rows"):
        spmm.spmv(plan, x[:100], "kahan")
    with pytest.raises(ValueError, match="device"):
        spmm.spmv(plan.to("cpu"), x, "kahan")
    with pytest.raises(ValueError, match="seg_k"):
        spmm.spmv(spmm.build_spmv_segments(g, k=3, device=cuda), x, "fast")
    with pytest.raises(TypeError, match="kahan"):
        spmm.spmv(plan, x.bfloat16(), "kahan")


def _check(got, plain, oracle_rows, oracle, bf16=False):
    got = got.float().cpu().numpy()
    plain = plain.float().cpu().numpy()
    if bf16:
        assert (np.abs(got - plain) <= _bf16_ulp(np.maximum(abs(got), abs(plain)))).all()
        assert (np.abs(got[oracle_rows] - oracle) <= _bf16_ulp(oracle)).all()
    else:
        # f32 sums in another order: 1e-5 absolute on values <= 1
        assert np.abs(got - plain).max() <= 1e-5
        assert np.abs(got[oracle_rows] - oracle).max() <= 1e-5


def _degree_graph(degrees, v, seed=0):
    """Row i (of the first len(degrees)) gets degrees[i] distinct random
    neighbours among rows >= len(degrees); the graph is undirected."""
    rng = np.random.default_rng(seed)
    lo = len(degrees)
    edges = [np.stack([np.full(d, i), lo + rng.choice(v - lo, d, replace=False)], 1)
             for i, d in enumerate(degrees)]
    return gt.build_graph(np.concatenate(edges), n_nodes=v)


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_kernel_beyond_one_panel(cuda, mode):
    """V = 60,000 rows do not fit one block's shared memory, and its hub
    rows hold few items: the stream runs the L2 column tiles."""
    v, width = 60_000, 256
    assert not spmm.sell_fits(v)
    rng = np.random.default_rng(4)
    edges = rng.integers(0, v, size=(200_000, 2))
    hub = np.stack([np.full(3000, 7), rng.choice(v, 3000, replace=False)], 1)
    g = gt.build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]), n_nodes=v)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert isinstance(plan.layout, spmm.TilePlan) and spmm.spmv_design(plan) == "tiles"
    x = torch.rand((v, width), generator=torch.Generator().manual_seed(4)).to(cuda)
    got = spmm.spmv(plan, x, mode, 0.6)
    rows = np.unique(np.concatenate([rng.choice(v, 300), [7, 0, v - 1]]))
    oracle = spmm.spmm_oracle(g, _pinned(x.cpu().numpy(), 0.6), rows=rows)
    _check(got, spmm.spmv_plain(plan, x, mode, 0.6), rows, oracle)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_narrowed_slab(cuda, dtype):
    """V = 16,384 (R-MAT's) rows of 16 bytes do not fit one block's shared
    memory, and narrower slabs lost to row tiles: the stream runs the L2
    column tiles (its hub row holds few items) in f32, row tiles in
    bf16."""
    v, width = 16_384, 72
    assert not spmm.sell_fits(v)
    g = _graph(v=v, e=120_000, seed=5)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert not isinstance(plan.layout, spmm.SellLayout)
    x = torch.rand((v, width), generator=torch.Generator().manual_seed(5)).to(cuda).to(dtype)
    got = spmm.spmv(plan, x, "fast", 0.6)
    rows = np.unique(np.concatenate([np.random.default_rng(5).choice(v, 300), [0, v - 1]]))
    oracle = spmm.spmm_oracle(g, _pinned(x.float().cpu().numpy(), 0.6), rows=rows)
    _check(got, spmm.spmv_plain(plan, x, "fast", 0.6), rows, oracle,
           bf16=dtype == torch.bfloat16)


@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode,dtype", [("kahan", torch.float32), ("fast", torch.float32),
                                        ("fast", torch.bfloat16)])
def test_panel_matches_row_tiles(cuda, mode, dtype, table_scale):
    """The panel and the row tiles sum a lane row's items in the same order
    with the same operations: bit-equal outputs; hub rows (a warp per row)
    within 1e-5 (bf16: one ulp)."""
    g = _graph(v=3000, e=40_000, seed=10)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert isinstance(plan.layout, spmm.SellLayout) and plan.layout.hub_rows.numel() > 0
    rows = spmm.row_tiles(plan)
    x = torch.rand((3000, 530), generator=torch.Generator().manual_seed(10)).to(cuda).to(dtype)
    a = spmm.spmv(plan, x, mode, table_scale)
    b = spmm.spmv(rows, x, mode, table_scale)
    lane = np.setdiff1d(np.arange(3001), plan.layout.hub_rows.cpu().numpy())
    lane = torch.as_tensor(lane, device=cuda)
    assert torch.equal(a[lane], b[lane])
    hub = plan.layout.hub_rows.long()
    ha, hb = a[hub].float().cpu().numpy(), b[hub].float().cpu().numpy()
    tol = _bf16_ulp(np.maximum(abs(ha), abs(hb))) if dtype == torch.bfloat16 else 1e-5
    assert (np.abs(ha - hb) <= tol).all()


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_kernel_rows_at_thresholds(cuda, mode):
    """Rows of exactly SELL_HUB items (lane rows), of SELL_HUB + 1 (hub rows)
    and of 32·SELL_HUB + 1 (a hub row of two pieces), beside a partly
    filled lane unit."""
    h, per_ss = spmm.SELL_HUB, 32 * spmm.SELL_WARPS
    degrees = [h, h + 1, h, h + 1, 32 * h + 1] + [3] * (per_ss - 4)
    v = len(degrees) + 6000
    g = _degree_graph(degrees, v)
    plan = spmm.build_spmv_stream(g, device=cuda)
    hubs = set(plan.layout.hub_rows.tolist())
    assert {1, 3, 4} <= hubs and not {0, 2} & hubs
    x = torch.rand((v, 40), generator=torch.Generator().manual_seed(6)).to(cuda)
    got = spmm.spmv(plan, x, mode)
    rows = np.arange(len(degrees) + 1)
    _check(got, spmm.spmv_plain(plan, x, mode), rows,
           spmm.spmm_oracle(g, x.cpu().numpy(), rows=rows))


def test_kernel_ragged_bf16(cuda):
    """C = 1,001 bf16 columns: rows are not 16-byte aligned, so the panel
    and the output go element by element."""
    g = _graph(seed=7)
    plan = spmm.build_spmv_stream(g, device=cuda)
    x = torch.rand((300, 1001), generator=torch.Generator().manual_seed(7)).to(cuda).bfloat16()
    got = spmm.spmv(plan, x, "fast", 0.6)
    oracle = spmm.spmm_oracle(g, _pinned(x.float().cpu().numpy(), 0.6))
    _check(got, spmm.spmv_plain(plan, x, "fast", 0.6), np.arange(300), oracle, bf16=True)


def test_kernel_uniform_fast_skips_padded_slots(cuda):
    """A uniform stream runs B2 without the weight multiply: the slices'
    pad positions (slot 0) must not be summed into short rows."""
    g = _degree_graph([1, 2, 5, 9, 40, 90] * 20, 2000, seed=8)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert plan.uniform and (plan.layout.item < 0).any()
    x = torch.rand((2000, 64), generator=torch.Generator().manual_seed(8)).to(cuda)
    x[0] = 4.0  # a summed pad would show
    got = spmm.spmv(plan, x, "fast")
    _check(got, spmm.spmv_plain(plan, x, "fast"), np.arange(2000),
           spmm.spmm_oracle(g, x.cpu().numpy()))


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_kernel_is_deterministic(cuda, mode):
    g = _graph(v=3000, e=40_000, seed=9)
    plan = spmm.build_spmv_stream(g, device=cuda)
    x = torch.rand((3000, 520), generator=torch.Generator().manual_seed(9)).to(cuda)
    a = spmm.spmv(plan, x, mode, 0.6)
    b = spmm.spmv(plan, x, mode, 0.6)
    assert torch.equal(a, b)


def _tiled(plan):
    """``plan`` run as the L2 column tiles, whatever its design."""
    return spmm.with_layout(plan, spmm.build_tile_plan(plan))


def _star_plus(v, hub_degree, e, seed):
    """Random edges and one hub row 0 of ``hub_degree`` distinct neighbours."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(1, v, size=(e, 2))
    hub = np.stack([np.zeros(hub_degree, np.int64), 1 + rng.permutation(v - 1)[:hub_degree]], 1)
    return gt.build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]), n_nodes=v)


@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
@pytest.mark.parametrize("case", ["rmat14", "arxiv", "star", "ragged", "weighted"])
def test_tiles_match_plain_and_row_tiles(cuda, case, mode, table_scale):
    """The L2 column tiles against the plain version and the float64 oracle
    (1e-5) and against the row tiles: bit-equal on rows of at most SELL_HUB
    items, within 1e-5 on hub rows (pieces joined in a fixed order).  R-MAT
    14 (many hub rows) at 264 columns; the arxiv shape at 520; a hub row of
    more than 32·SELL_HUB items; C = 1,001 (rows not 16-byte aligned); a
    weighted stream."""
    from graphtpu_torch.bench import generators

    weighted = case == "weighted"
    g, width = {
        "rmat14": lambda: (generators.rmat14_graph(), 264),
        "arxiv": lambda: (generators.arxiv_shaped_graph(), 520),
        "star": lambda: (_star_plus(13_000, 32 * spmm.SELL_HUB + 900, 20_000, 11), 300),
        "ragged": lambda: (_star_plus(12_000, 700, 30_000, 12), 1001),
        "weighted": lambda: (_graph(v=3000, e=40_000, seed=13, weighted=True), 300),
    }[case]()
    v = g.n_nodes
    plan = _tiled(spmm.build_spmv_stream(g, weighted=weighted, device=cuda))
    x = torch.rand((v, width), generator=torch.Generator().manual_seed(14)).to(cuda)
    got = spmm.spmv(plan, x, mode, table_scale)
    rows = spmm.spmv(spmm.row_tiles(plan), x, mode, table_scale)
    lane = torch.diff(plan.row_items) <= spmm.SELL_HUB
    assert torch.equal(got[lane], rows[lane])
    if (~lane).any():
        assert (got[~lane] - rows[~lane]).abs().max().item() <= 1e-5
    orows = np.unique(np.concatenate([np.random.default_rng(15).choice(v, 200), [0, v - 1]]))
    table = x.cpu().numpy() if table_scale is None else _pinned(x.cpu().numpy(), table_scale)
    oracle = spmm.spmm_oracle(g, table, weighted=weighted, rows=orows)
    _check(got, spmm.spmv_plain(plan, x, mode, table_scale), orows, oracle)


def test_tiles_take_f32_only(cuda):
    """A stream with a tile plan runs row tiles over a bf16 table: the
    same bits as the row tiles, none of the tiles' launches."""
    from graphtpu_torch.bench import generators

    plan = spmm.build_spmv_stream(generators.arxiv_shaped_graph(), device=cuda)
    assert spmm.spmv_design(plan) == "tiles"
    assert spmm.spmv_design(plan, torch.bfloat16) == "rows"
    x = torch.rand((plan.n_nodes, 264), generator=torch.Generator().manual_seed(16))
    x = x.to(cuda).bfloat16()
    assert torch.equal(spmm.spmv(plan, x, "fast", 0.6),
                       spmm.spmv(spmm.row_tiles(plan), x, "fast", 0.6))


def test_tiles_are_deterministic_and_counted(cuda):
    g = _star_plus(12_000, 3 * spmm.SELL_HUB + 5, 30_000, 17)
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert spmm.spmv_design(plan) == "tiles"
    assert plan.layout.hub_rows[0].item() == 0 and plan.layout.hub_piece[1].item() == 4
    x = torch.rand((12_000, 520), generator=torch.Generator().manual_seed(17)).to(cuda)
    before = dict(spmm.SPMV_LAUNCHES)
    for mode in ("kahan", "fast"):
        assert torch.equal(spmm.spmv(plan, x, mode, 0.6), spmm.spmv(plan, x, mode, 0.6))
    assert spmm.SPMV_LAUNCHES["kahan"] == before["kahan"] + 2
    assert spmm.SPMV_LAUNCHES["fast"] == before["fast"] + 2


def _small_random():
    rng = np.random.default_rng(42)
    edges = rng.integers(0, 64, size=(400, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(64), (np.arange(64) + 1) % 64], 1)
    return gt.build_graph(np.concatenate([edges, ring]), n_nodes=64)


@pytest.mark.parametrize(
    "mode,dtype,seg",
    [("kahan", torch.float32, 1), ("fast", torch.float32, 1),
     ("kahan", torch.float32, 2), ("fast", torch.bfloat16, 1)],
)
def test_simrank_spmm_on_card_matches_cpu(cuda, mode, dtype, seg):
    g = _small_random()
    # seg-2 of an unweighted graph runs the column panel's seg-k walk
    assert spmm.spmv_design(spmm.build_spmv_segments(g, k=seg, device=cuda), dtype) == "panel"
    before = sum(spmm.SPMV_LAUNCHES.values())
    got = exact_simrank_spmm(g, spmv_mode=mode, dtype=dtype, spmv_seg=seg, device=cuda)
    assert sum(spmm.SPMV_LAUNCHES.values()) == before + 6
    cpu = exact_simrank_spmm(g, spmv_mode=mode, dtype=dtype, spmv_seg=seg, device="cpu")
    dense = exact_simrank(g, device=cuda)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got.float().cpu() - cpu.float()).abs().max().item() <= tol
    assert (got.float() - dense).abs().max().item() <= tol


def test_cli_on_card_matches_cpu(cuda, tmp_path):
    g = _small_random()
    rp, col, _, _ = g.host
    src = np.repeat(np.arange(64), np.diff(rp))
    path = str(tmp_path / "g.txt")
    write_edgelist(path, np.stack([src[src < col], col[src < col]], 1))
    common = ["simrank", "--input", path, "--engine", "spmm", "--topk", "10"]
    assert cli_main(common + ["--output", str(tmp_path / "a.txt")]) == 0
    assert cli_main(common + ["--output", str(tmp_path / "b.txt"), "--device", "cpu"]) == 0
    a = read_sim_file(str(tmp_path / "a.txt.sim.txt"))
    b = read_sim_file(str(tmp_path / "b.txt.sim.txt"))
    assert set(a) == set(b) == set(range(64))
    for r in a:
        np.testing.assert_allclose([s for _, s in a[r]], [s for _, s in b[r]], atol=2e-5)


def _rmat14(cuda, hot=None):
    """R-MAT 14's stream on the card: the packed-lane panel (hub rows hold
    58% of the items, its 11,448 most-read rows 99.7% of the reads), or
    with a panel of ``hot`` rows."""
    from graphtpu_torch.bench import generators

    g = generators.rmat14_graph()
    plan = spmm.build_spmv_stream(g, device=cuda)
    assert spmm.spmv_design(plan) == spmm.spmv_design(plan, torch.bfloat16) == "packed"
    if hot is not None:
        plan = spmm.with_layout(plan, spmm.build_packed_layout(plan, hot=hot))
    return g, plan


@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode,dtype", [("kahan", torch.float32), ("fast", torch.float32),
                                        ("fast", torch.bfloat16)])
@pytest.mark.parametrize("case", ["rmat14", "cold", "ragged"])
def test_packed_matches_plain_oracle_and_row_tiles(cuda, case, mode, dtype, table_scale):
    """The packed-lane panel at R-MAT 14 (its 11,448 hottest rows in the
    panel; "cold": 300, so 1 in 3 reads goes to the table; "ragged": C =
    1,001, rows not 16-byte aligned) against the plain version and the
    float64 oracle (1e-5, bf16 one ulp), bit-equal to the forced row tiles
    on rows of at most PACK_PIECE items (one lane each, in stream order),
    within 1e-5 (bf16 one ulp) on the longer ones, and the same bits on a
    second launch."""
    g, plan = _rmat14(cuda, hot=300 if case == "cold" else None)
    v, width = g.n_nodes, 1001 if case == "ragged" else 520
    bf = dtype == torch.bfloat16
    x = torch.rand((v, width), generator=torch.Generator().manual_seed(18)).to(cuda).to(dtype)
    got = spmm.spmv(plan, x, mode, table_scale)
    assert torch.equal(got, spmm.spmv(plan, x, mode, table_scale))
    rows = spmm.spmv(spmm.row_tiles(plan), x, mode, table_scale)
    cnt = torch.diff(plan.row_items)
    light = cnt <= spmm.PACK_PIECE
    assert torch.equal(got[light], rows[light])
    ha, hb = got[~light].float().cpu().numpy(), rows[~light].float().cpu().numpy()
    tol = _bf16_ulp(np.maximum(abs(ha), abs(hb))) if bf else 1e-5
    assert (np.abs(ha - hb) <= tol).all()
    orows = np.unique(np.concatenate([np.random.default_rng(19).choice(v, 200),
                                      [int(np.argmax(g.host[3])), 0, v - 1]]))
    xh = x.float().cpu().numpy()
    oracle = spmm.spmm_oracle(g, xh if table_scale is None else _pinned(xh, table_scale),
                              rows=orows)
    _check(got, spmm.spmv_plain(plan, x, mode, table_scale), orows, oracle, bf16=bf)


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_packed_writes_rows_with_no_items(cuda, mode):
    """Rows with no items (here 3, 7, 200 and the pad row V) are zeros;
    the rest as the row tiles.  Row 5 holds 30% of the items, and every
    item reads one of the first 11,000 rows: the packed design."""
    rng = np.random.default_rng(8)
    v, n = 12_000, 40_000
    rows = np.setdiff1d(np.arange(v), [3, 7, 200])
    pos = np.sort(np.concatenate([rows, rng.choice(rows, n - len(rows) - 12_000),
                                  np.full(12_000, 5)]))
    slots = rng.integers(0, 11_000, n)
    deg = np.bincount(pos, minlength=v + 1).astype(np.float32)
    st = spmm.stream_from_numpy(slots, 1.0 / deg[pos], pos, np.ones(n), 1.0 / deg[pos], v, n,
                                1, True, device=cuda)
    assert spmm.spmv_design(st) == "packed"
    assert set(st.layout.empty_rows.tolist()) == {3, 7, 200, v}
    x = torch.rand((v, 264), generator=torch.Generator().manual_seed(20)).to(cuda)
    got = spmm.spmv(st, x, mode, 0.6)
    assert not got[[3, 7, 200, v]].any()
    light = torch.diff(st.row_items) <= spmm.PACK_PIECE
    assert torch.equal(got[light], spmm.spmv(spmm.row_tiles(st), x, mode, 0.6)[light])


def test_packed_launches_are_counted(cuda):
    _, plan = _rmat14(cuda)
    x = torch.rand((plan.n_nodes, 64), device=cuda)
    before = dict(spmm.SPMV_LAUNCHES)
    spmm.spmv(plan, x, "kahan", 0.6)
    spmm.spmv(plan, x, "fast")
    spmm.spmv(plan, x.bfloat16(), "fast", 0.6)
    spmm.spmv_plain(plan, x, "fast")
    assert spmm.SPMV_LAUNCHES["kahan"] == before["kahan"] + 1
    assert spmm.SPMV_LAUNCHES["fast"] == before["fast"] + 2


@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("case", ["ragged", "arxiv", "seg2"])
def test_bf16_row_tiles_give_the_f32_loads_bits(cuda, case, table_scale):
    """The bf16 row tiles read 8 columns a thread with one 16-byte load; the
    f32 row tiles read 4.  Both sum each column in f32 in the same order
    with the same operations, and bf16 rounds once on the store, so the
    bf16 output is the f32 row tiles' over the widened table, rounded: at
    C = 1,001 (element by element), at the arxiv shape and over a seg-2
    stream."""
    from graphtpu_torch.bench import generators

    if case == "arxiv":
        g, width = generators.arxiv_shaped_graph(), 1040
    else:
        g, width = _graph(v=3000, e=40_000, seed=21), 1001 if case == "ragged" else 1040
    k = 2 if case == "seg2" else 1
    plan = spmm.row_tiles(spmm.build_spmv_segments(g, k=k, device=cuda))
    x = torch.rand((g.n_nodes, width), generator=torch.Generator().manual_seed(22))
    x = x.to(cuda).bfloat16()
    got = spmm.spmv(plan, x, "fast", table_scale)
    want = spmm.spmv(plan, x.float(), "fast", table_scale).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _seg_graph(v=3000, e=30_000, seed=23):
    """Random edges among rows [0, v - 4), relabelled by RCM, a hub row 0 of
    300 neighbours; row 1 joined to row v - 1, whose neighbour v - 2 is
    isolated (a seg-k window clamped at the table's end, sub-row 0
    masked); rows v - 4 .. v - 2 isolated."""
    from graphtpu_torch.core.reorder import rcm_order

    rng = np.random.default_rng(seed)
    n = v - 4
    edges = rng.integers(0, n, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    inv = np.empty(n, np.int64)
    inv[rcm_order(gt.build_graph(edges, n_nodes=n))] = np.arange(n)
    edges = inv[edges]
    hub = np.stack([np.zeros(300, np.int64), 2 + rng.permutation(n - 2)[:300]], 1)
    return gt.build_graph(np.concatenate([edges, hub, [[1, v - 1]]]), n_nodes=v)


@pytest.mark.parametrize("width", [1040, 1001])
@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode,dtype", [("kahan", torch.float32), ("fast", torch.float32),
                                        ("fast", torch.bfloat16)])
@pytest.mark.parametrize("k", [2, 4])
def test_seg_panel_matches_row_tiles(cuda, k, mode, dtype, table_scale, width):
    """An unweighted seg-k stream runs the column panel's seg-k walk: bit-equal
    to the forced row tiles on lane rows (every row of at most SELL_HUB
    positions), hub rows within 1e-5 of the plain version (bf16 one ulp),
    the clamped window's row and the isolated rows too, the same bits on a
    second launch, each launch counted."""
    g = _seg_graph()
    v = g.n_nodes
    plan = spmm.build_spmv_segments(g, k=k, device=cuda)
    assert spmm.spmv_design(plan, dtype) == "panel" and plan.layout.n_pieces > 0
    raw = plan.raw_wts.view(-1, k).cpu().numpy()
    slots = plan.slots.cpu().numpy()
    clamped = (slots == v - k) & (raw[:, 0] == 0) & (raw[:, k - 1] != 0)
    assert clamped.any()
    bf = dtype == torch.bfloat16
    x = torch.rand((v, width), generator=torch.Generator().manual_seed(24)).to(cuda).to(dtype)
    before = dict(spmm.SPMV_LAUNCHES)
    got = spmm.spmv(plan, x, mode, table_scale)
    assert torch.equal(got, spmm.spmv(plan, x, mode, table_scale))
    assert spmm.SPMV_LAUNCHES[mode] == before[mode] + 2
    rows = spmm.spmv(spmm.row_tiles(plan), x, mode, table_scale)
    lane = torch.ones(v + 1, dtype=torch.bool, device=cuda)
    lane[plan.layout.hub_rows.long()] = False
    assert torch.equal(got[lane], rows[lane])
    assert not got[[v - 4, v - 3, v - 2, v]].any()
    plain = spmm.spmv_plain(plan, x, mode, table_scale)
    ha, hb = got[~lane].float().cpu().numpy(), plain[~lane].float().cpu().numpy()
    tol = _bf16_ulp(np.maximum(abs(ha), abs(hb))) if bf else 1e-5
    assert (np.abs(ha - hb) <= tol).all()
    xh = x.float().cpu().numpy()
    orows = np.unique(np.concatenate([np.random.default_rng(25).choice(v, 200), [0, 1, v - 1]]))
    oracle = spmm.spmm_oracle(g, xh if table_scale is None else _pinned(xh, table_scale),
                              rows=orows)
    _check(got, plain, orows, oracle, bf16=bf)


@pytest.mark.parametrize("k", [2, 4])
def test_weighted_seg_stays_on_row_tiles(cuda, k):
    """A weighted seg-k stream's coefficients differ within a row: no sliced
    layout, row tiles, within 1e-5 of the plain version."""
    g = _seg_graph()
    rng = np.random.default_rng(26)
    rp, col, _, _ = g.host
    src = np.repeat(np.arange(g.n_nodes), np.diff(rp))
    keep = src < col
    gw = gt.build_graph(np.stack([src[keep], col[keep]], 1),
                        weights=(rng.random(int(keep.sum())) + 0.1).astype(np.float32),
                        n_nodes=g.n_nodes)
    plan = spmm.build_spmv_segments(gw, weighted=True, k=k, device=cuda)
    assert not plan.mask_uniform and plan.layout is None and spmm.spmv_design(plan) == "rows"
    x = torch.rand((g.n_nodes, 520), generator=torch.Generator().manual_seed(27)).to(cuda)
    for mode in ("kahan", "fast"):
        got = spmm.spmv(plan, x, mode, 0.6)
        assert (got - spmm.spmv_plain(plan, x, mode, 0.6)).abs().max().item() <= 1e-5


# ragged shapes (scalar path where R, C or the pointer miss 16 bytes'
# worth), whole-chunk shapes, several tiles and runs of tile rows
TRANSPOSE_SHAPES = [(1, 300), (300, 1), (33, 65), (257, 4097), (96, 200), (2056, 4104),
                    "offset", "v32768"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRANSPOSE_SHAPES)
def test_transpose_kernel_equals_plain(cuda, shape, dtype):
    """The kernel's bits against ``x.t().contiguous()``; "offset" starts one
    element past a 16-byte boundary, "v32768" is the first 32,768 rows of a
    [32,769, 32,768] product, the stream branch's ``ps[:v]`` at the gold
    cells' V."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    if shape == "offset":
        x = torch.randn(1 + 96 * 200, generator=gen, device=cuda).to(dtype)[1:].view(96, 200)
        assert x.data_ptr() % 16 != 0
    elif shape == "v32768":
        x = torch.randn((32_769, 32_768), generator=gen, device=cuda).to(dtype)[:32_768]
    else:
        x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = transpose.TRANSPOSE_LAUNCHES["transpose"]
    got = transpose.transpose_2d(x)
    torch.cuda.synchronize()
    assert transpose.TRANSPOSE_LAUNCHES["transpose"] == before + 1
    assert got.shape == (x.shape[1], x.shape[0]) and got.is_contiguous()
    assert torch.equal(got, x.t().contiguous())


def test_transpose_rejects_on_the_card(cuda):
    with pytest.raises(ValueError):
        transpose.transpose_2d(torch.zeros((8, 8), device=cuda)[:, ::2])
    with pytest.raises(TypeError):
        transpose.transpose_2d(torch.zeros((8, 8), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        transpose.transpose_2d(torch.zeros((2, 8, 8), device=cuda))


@pytest.mark.parametrize("graph", ["small", "v1030", "v3000"])
@pytest.mark.parametrize("case", ["kahan", "kahan_tiles", "kahan_rows", "fast16", "tree"])
def test_simrank_spmm_transpose_kernel_bit_equal(cuda, case, graph, monkeypatch):
    """A solve's scores with the kernel equal those with the plain
    transpose, bit for bit, on the stream's own design (the column panel),
    the L2 column tiles and row tiles (as chip_smoke.forced_row_tiles
    forces), fast16's bf16 iterates and the tree branch; one launch an
    iteration.  V = 1,030 runs the kernel's element path, 3,000 whole
    chunks over several runs of tile rows."""
    g = {"small": _small_random,
         "v1030": lambda: _graph(v=1030, e=12_000, seed=32),
         "v3000": lambda: _graph(v=3000, e=30_000, seed=33)}[graph]()
    kw = {"fast16": dict(spmv_mode="fast", dtype=torch.bfloat16),
          "tree": dict(impl="tree")}.get(case, {})
    build = exact.build_spmv_stream
    if case == "kahan_tiles":
        monkeypatch.setattr(exact, "build_spmv_stream", lambda *a, **k: _tiled(build(*a, **k)))
    if case == "kahan_rows":
        monkeypatch.setattr(exact, "build_spmv_stream",
                            lambda *a, **k: spmm.row_tiles(build(*a, **k)))
    cfg = SimRankConfig(iterations=4)
    before = transpose.TRANSPOSE_LAUNCHES["transpose"]
    got = exact_simrank_spmm(g, cfg, device=cuda, **kw)
    torch.cuda.synchronize()
    assert transpose.TRANSPOSE_LAUNCHES["transpose"] == before + cfg.iterations
    monkeypatch.setattr(exact, "transpose_2d", transpose.transpose_2d_plain)
    plain = exact_simrank_spmm(g, cfg, device=cuda, **kw)
    assert transpose.TRANSPOSE_LAUNCHES["transpose"] == before + cfg.iterations
    assert torch.equal(got, plain)
