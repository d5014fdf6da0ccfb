"""Kernels B1/B2 of graphtpu_torch on an NVIDIA GPU, against their plain
PyTorch version and the float64 oracle.  Every test needs a card and skips
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


def test_kahan_hub_beats_plain_sum(cuda):
    """A row of degree 20,000 over equal values per column: a plain f32 sum
    (kernel B2) misses the float64 oracle by more than 1e-5, B1 does not."""
    d, width = 20_000, 1000
    star = np.stack([np.zeros(d, np.int64), np.arange(1, d + 1)], 1)
    g = gt.build_graph(star, n_nodes=d + 1)
    vals = (1 + np.random.default_rng(0).random(width)).astype(np.float32)
    x = torch.from_numpy(np.broadcast_to(vals, (d + 1, width)).copy()).to(cuda)
    plan = spmm.build_spmv_stream(g, device=cuda)
    oracle = spmm.spmm_oracle(g, x.cpu().numpy(), rows=[0])[0]
    kahan = spmm.spmv(plan, x, "kahan")[0].cpu().numpy()
    fast = spmm.spmv(plan, x, "fast")[0].cpu().numpy()
    assert np.abs(kahan - oracle).max() <= 1e-5
    assert np.abs(fast - oracle).max() > 1e-5


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
    before = sum(spmm.SPMV_LAUNCHES.values())
    got = exact_simrank_spmm(g, spmv_mode=mode, dtype=dtype, spmv_seg=seg, device=cuda)
    assert sum(spmm.SPMV_LAUNCHES.values()) == before + 6
    cpu = exact_simrank_spmm(g, spmv_mode=mode, dtype=dtype, spmv_seg=seg)
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
