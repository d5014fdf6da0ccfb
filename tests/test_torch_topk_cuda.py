"""The row top-k kernel of graphtpu_torch (``kernels/topk.py`` over
``csrc/topk.cu``) on an NVIDIA GPU: values and indices bit-equal to the
first k of a stable descending ``torch.sort`` on the card, for SimRank
iterates, UniWalk's candidate tiles, bf16 rows, all-zero rows, ties,
+-0.0, +-inf and +NaN, every k from 1 to 1,024, short, long and
misaligned rows; the masked diagonal, the launch count,
the callers, and the memory a call takes.  Every test needs a card and
skips without one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_topk_cuda.py
"""

import numpy as np
import pytest
import torch

from graphtpu_torch.bench.generators import rmat_graph, uniform_random_graph
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.kernels import topk
from graphtpu_torch.simrank import exact
from graphtpu_torch.simrank.exact import exact_simrank_spmm

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
V = 32_768
POS_NAN = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def iterates():
    """Exact SimRank scores at V = 32,768 after 3 kahan iterations, the
    diagonal zeroed: a uniform random graph (average degree 32) and an
    R-MAT graph (Graph500's initiator, edge factor 16; isolated nodes give
    all-zero rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    out = {}
    for name, edges in (("urand", uniform_random_graph(V, 32, seed=3)),
                        ("rmat", rmat_graph(15, 16 * V, seed=3))):
        g = build_graph(edges, n_nodes=V, device=dev)
        out[name] = exact_simrank_spmm(g, SimRankConfig(iterations=3), device=dev)
    return out


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _sort_first(x, k):
    sv, si = torch.sort(x, dim=1, descending=True, stable=True)
    return sv[:, :k], si[:, :k]


def _assert_sort_order(x, k):
    """One launch, and the values' bits and the indices of the sort's first k."""
    before = topk.TOPK_LAUNCHES["topk"]
    vals, idx = topk._stable_topk(x, k)
    torch.cuda.synchronize()
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want_v, want_i = _sort_first(x, k)
    assert vals.dtype == x.dtype and idx.dtype == torch.int64
    assert vals.shape == want_v.shape and idx.shape == want_i.shape
    assert torch.equal(idx, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))


def _rand(shape, dev, seed, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("rows", ["head", "tail", "all"])
@pytest.mark.parametrize("graph", ["urand", "rmat"])
def test_iterate_rows(cuda, iterates, graph, rows):
    """512 rows of a [V, V] iterate from either end, and all V rows (the
    gold cells' call)."""
    s = iterates[graph]
    x = {"head": s[:512], "tail": s[-512:], "all": s}[rows]
    _assert_sort_order(x, 20)


def test_iterate_rows_bf16(cuda, iterates):
    _assert_sort_order(iterates["urand"][:512].bfloat16(), 20)


@pytest.mark.parametrize("k", [1, 20, 100, 1024])
def test_uniwalk_tile(cuda, k):
    """[256, 50,000] candidate totals, ~70% -inf (segment_topk's selection)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.rand((256, 50_000), generator=gen, device=cuda)
    live = torch.rand((256, 50_000), generator=gen, device=cuda) < 0.3
    _assert_sort_order(torch.where(live, x * 1e-3, float("-inf")), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 20, 100, 1024])
@pytest.mark.parametrize("kind", ["randn", "ties", "zeros", "special"])
def test_kinds_of_rows(cuda, kind, k, dtype):
    """Gaussian rows; rows of four values (long runs of exact ties); all-zero
    rows; rows of +-0.0, +-inf, +NaN, +-1 and 0.5."""
    shape = (96, 4_097)
    if kind == "randn":
        x = _rand(shape, cuda, k, dtype)
    elif kind == "ties":
        x = (torch.randint(0, 4, shape, device=cuda) / 4).to(dtype)
    elif kind == "zeros":
        x = torch.zeros(shape, dtype=dtype, device=cuda)
    else:
        pool = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.0, -1.0,
                             0.5], device=cuda).to(dtype)
        x = pool[torch.randint(0, 8, shape, device=cuda)]
        x[torch.isnan(x)] = torch.tensor(POS_NAN[dtype], dtype=_bits(x).dtype,
                                         device=cuda).view(dtype)
        assert (_bits(x[torch.isnan(x)]) == POS_NAN[dtype]).all()
    _assert_sort_order(x, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [20, 100])
@pytest.mark.parametrize("kind", ["plateau", "block", "block-ties"])
def test_rows_for_each_select_path(cuda, kind, k, dtype):
    """Rows that take the kernel's other paths: "plateau", 1,000 ones among
    zeros (more keys at the bound than a list of 128 ranks directly: the
    radix select over the list); "block", 300 distinct values in the
    first columns and zeros elsewhere (more than k keys above the bound
    and too many at it: the radix select over the row); "block-ties",
    the same block of four values (its passes run into the columns)."""
    shape = (64, 32_768)
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.zeros(shape, device=cuda)
    if kind == "plateau":
        x[torch.rand(shape, generator=gen, device=cuda) < 1_000 / 32_768] = 1.0
    elif kind == "block":
        x[:, :300] = torch.rand((64, 300), generator=gen, device=cuda) + 0.5
    else:
        x[:, :300] = torch.randint(1, 5, (64, 300), generator=gen, device=cuda).float()
    _assert_sort_order(x.to(dtype), k)


@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 128, 1_001, 4_096, 4_097, 32_768, 51_200,
                               51_201, 100_001])
def test_row_lengths(cuda, n):
    """Short rows, rows whose length misaligns the next row (1,001, 33;
    the element-by-element path), and long rows; each also rounded to
    ties, where the list overflows and k reaches 1,024."""
    x = _rand((24, n), cuda, n)
    _assert_sort_order(x, 20)
    _assert_sort_order((x * 4).round(), min(n, 1024))  # ties


@pytest.mark.parametrize("n", [102_400, 102_401, 150_001])
def test_bf16_row_lengths(cuda, n):
    x = _rand((8, n), cuda, n, torch.bfloat16)
    _assert_sort_order(x, 20)
    _assert_sort_order((x * 2).round(), 1024)


def test_misaligned_pointer(cuda):
    """A contiguous view that starts one element past a 16-byte boundary."""
    x = _rand(1 + 64 * 5_000, cuda, 5)[1:].view(64, 5_000)
    assert x.data_ptr() % 16 != 0
    _assert_sort_order(x, 20)


def test_topk_rows_pads_short_rows(cuda):
    x = _rand((8, 7), cuda, 8)
    vals, idx = topk.topk_rows(x, 20)
    want_v, want_i = _sort_first(x, 7)
    assert vals.shape == (8, 20) and idx.dtype == torch.int32
    assert torch.equal(vals[:, :7], want_v) and torch.equal(idx[:, :7].long(), want_i)
    assert (vals[:, 7:] == 0).all() and (idx[:, 7:] == -1).all()
    vals, idx = topk.topk_rows(_rand((100, 1), cuda, 9), 20)
    assert vals.shape == (100, 20) and (idx[:, 0] == 0).all() and (idx[:, 1:] == -1).all()


def test_no_rows(cuda):
    before = topk.TOPK_LAUNCHES["topk"]
    vals, idx = topk.topk_rows(torch.empty((0, 50), device=cuda), 20)
    assert vals.shape == (0, 20) and idx.shape == (0, 20)
    v2, i2 = topk._stable_topk(torch.empty((0, 50), device=cuda), 20)
    assert v2.shape == (0, 20) and i2.dtype == torch.int64
    assert topk.TOPK_LAUNCHES["topk"] == before


@pytest.mark.parametrize("offset", [0, 3, 900])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_diagonal_equals_the_masked_clone(cuda, offset, dtype):
    """``exclude_diag_offset=r`` reads column r + i of row i as -inf, as the
    CPU path's masked copy does; the kernel takes the offset, no copy."""
    x = (torch.randint(0, 3, (100, 1_000), device=cuda) / 2).to(dtype)
    x[torch.arange(100), offset + torch.arange(100)] = 5.0  # the diagonal would win
    before = topk.TOPK_LAUNCHES["topk"]
    vals, idx = topk.topk_rows(x, 20, exclude_diag_offset=offset)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    masked = x.clone()
    masked[torch.arange(100), offset + torch.arange(100)] = float("-inf")
    want_v, want_i = _sort_first(masked, 20)
    assert torch.equal(_bits(vals), _bits(want_v)) and torch.equal(idx.long(), want_i)
    # a row whose every entry is the masked one: -inf at its column
    one = torch.ones((4, 4), dtype=dtype, device=cuda)
    vals, idx = topk.topk_rows(one, 4, exclude_diag_offset=0)
    assert torch.equal(idx[:, 3].long(), torch.arange(4, device=cuda))
    assert torch.isneginf(vals[:, 3].float()).all()


def test_rejects_on_the_card(cuda):
    before = topk.TOPK_LAUNCHES["topk"]
    with pytest.raises(TypeError, match="float32"):
        topk._stable_topk(torch.zeros((4, 8), dtype=torch.float64, device=cuda), 2)
    with pytest.raises(TypeError, match="float32"):
        topk._stable_topk(torch.zeros((4, 8), dtype=torch.float16, device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        topk._stable_topk(torch.zeros((8, 4), device=cuda).t(), 2)
    with pytest.raises(ValueError, match="1024"):
        topk._stable_topk(torch.zeros((2, 2_000), device=cuda), 1_025)
    with pytest.raises(ValueError, match="leave"):
        topk.topk_rows(torch.zeros((4, 8), device=cuda), 2, exclude_diag_offset=6)
    assert topk.TOPK_LAUNCHES["topk"] == before


def test_memory_is_the_outputs(cuda):
    """Over a [4,096, 32,768] top-k the allocator's peak rises by the two
    outputs and no more than 1 MB besides."""
    x = _rand((4_096, V), cuda, 11).abs()
    topk._stable_topk(x, 20)  # the library built and loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vals, idx = topk._stable_topk(x, 20)
    torch.cuda.synchronize()
    outputs = vals.numel() * vals.element_size() + idx.numel() * idx.element_size()
    assert torch.cuda.max_memory_allocated() - base <= outputs + (1 << 20)


def test_callers_go_through_the_kernel(cuda):
    """merge_topk, segment_topk's selection and bounded_slots_to_topk launch
    the kernel on the card and give the CPU's answers."""
    cpu = torch.device("cpu")
    a, b = _rand((64, 300), cuda, 1), _rand((64, 300), cuda, 2)
    va, ia = topk.topk_rows(a, 20)
    vb, ib = topk.topk_rows(b, 20)
    before = topk.TOPK_LAUNCHES["topk"]
    got = topk.merge_topk(va, ia, vb, ib + 300, 20)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want = topk.merge_topk(va.to(cpu), ia.to(cpu), vb.to(cpu), ib.to(cpu) + 300, 20)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])

    rng = np.random.default_rng(4)
    tg = torch.from_numpy(rng.integers(-1, 900, size=(128, 4_000)).astype(np.int32))
    v = torch.from_numpy((rng.integers(1, 5, size=(128, 4_000)) / 4).astype(np.float32))
    before = topk.TOPK_LAUNCHES["topk"]
    got = topk.segment_topk(tg.to(cuda), v.to(cuda), 20, 900)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want = topk.segment_topk(tg, v, 20, 900)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])

    keys = torch.from_numpy(rng.integers(-1, 50, size=(32, 200)).astype(np.int32))
    vals = torch.from_numpy(rng.random((32, 200)).astype(np.float32))
    sk, sv = topk.bounded_topk_accumulate(keys, vals, capacity=16)
    before = topk.TOPK_LAUNCHES["topk"]
    got = topk.bounded_slots_to_topk(sk.to(cuda), sv.to(cuda), 8)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want = topk.bounded_slots_to_topk(sk, sv, 8)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("mode", ["kahan", "fast16"])
def test_simrank_topk_of_a_solve(cuda, mode):
    """``simrank_topk`` after a solve: one launch, and the arrays the plain
    sort gives."""
    g = build_graph(uniform_random_graph(3_000, 16, seed=2), n_nodes=3_000, device=cuda)
    kw = dict(spmv_mode="fast", dtype=torch.bfloat16) if mode == "fast16" else {}
    sim = exact_simrank_spmm(g, SimRankConfig(iterations=5), device=cuda, **kw)
    before = topk.TOPK_LAUNCHES["topk"]
    vals, idx = exact.simrank_topk(sim, 20)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want_v, want_i = topk.stable_topk_plain(sim, 20)
    assert topk.TOPK_LAUNCHES["topk"] == before + 1
    want_v = want_v.float().cpu().numpy()
    np.testing.assert_array_equal(vals.view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(idx, want_i.int().cpu().numpy())
