"""Kernels B3 (tree level) and X1-X3 (item-rate variants) of graphtpu_torch
on an NVIDIA GPU, against their plain PyTorch versions, and the tree
branch of exact SimRank on the card against the CPU.  Every test needs a
card and skips without one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_tree_cuda.py
"""

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


def test_launch_counts(cuda):
    st = _stream(cuda)
    x = torch.rand((300, 64), device=cuda)
    buf = torch.rand((spmv_rate.N_BUF, 64), device=cuda)
    slots, wts = _level(cuda, n=300)
    before = dict(spmv_rate.RATE_LAUNCHES)
    g_before = spmm.GATHER_LAUNCHES["gather_rows_sum"]
    spmv_rate.gather_only(st, x)
    spmv_rate.unroll8(st, x)
    spmv_rate.unroll8(st, x)
    spmv_rate.accumulate_only(st, buf)
    spmv_rate.unroll8_plain(st, x)
    spmm.gather_rows_sum(slots, wts, x)
    spmm.gather_rows_sum_plain(slots, wts, x)
    assert spmv_rate.RATE_LAUNCHES == {
        "gather_only": before["gather_only"] + 1,
        "accumulate_only": before["accumulate_only"] + 1,
        "unroll8": before["unroll8"] + 2,
    }
    assert spmm.GATHER_LAUNCHES["gather_rows_sum"] == g_before + 1


def test_rate_wrappers_reject_bad_inputs(cuda):
    st = _stream(cuda)
    x = torch.rand((300, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_rate.unroll8(st, torch.rand((64, 300), device=cuda).t())
    with pytest.raises(ValueError, match="device"):
        spmv_rate.gather_only(st.to("cpu"), x)
    with pytest.raises(TypeError, match="float32"):
        spmv_rate.unroll8(st, x.bfloat16())
