"""graphtpu_torch streaming products: host plans bit-equal to graphtpu's,
the plain version of kernels B1/B2 against graphtpu's Pallas kernels (run
in interpret mode) and the float64 oracle, and the dispatch rules."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.kernels import spmm as jspmm
from graphtpu_torch.core.convert import stream_from_numpy
from graphtpu_torch.kernels import _build
from graphtpu_torch.kernels import spmm as tspmm

torch.set_num_threads(1)

C = 1024  # the Pallas kernels' column quantum


def _edges(v=67, e=600, seed=0, weighted=False, hub=True):
    """tests/test_spmm.py's shapes: a hub row and an isolated last node."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    if hub:
        hub_edges = np.stack([np.zeros(v - 2, np.int64), np.arange(1, v - 1)], 1)
        edges = np.concatenate([edges, hub_edges])
    edges = edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    return edges, wts


def _pair(v=67, e=600, seed=0, weighted=False, hub=True):
    edges, wts = _edges(v, e, seed, weighted, hub)
    return (
        gt.build_graph(edges, weights=wts, n_nodes=v),
        graphtpu.build_graph(edges, weights=wts, n_nodes=v),
    )


def _plan(pkg, g, weighted, block_items, k):
    if k == 1:
        return pkg.build_spmv_stream(g, weighted=weighted, block_items=block_items)
    return pkg.build_spmv_segments(g, weighted=weighted, block_items=block_items, k=k)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


@pytest.mark.parametrize("block_items", [16, 64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_plan_matches_graphtpu_bitwise(k, weighted, block_items):
    tg, jg = _pair(weighted=weighted)
    got = _plan(tspmm, tg, weighted, block_items, k)
    want = _plan(jspmm, jg, weighted, block_items, k)
    for f in ("slots", "wts", "pos", "raw_wts", "scales"):
        assert _bits(getattr(got, f).numpy()) == _bits(np.asarray(getattr(want, f))), f
    for f in ("n_nodes", "n_items", "block_items", "uniform", "seg_k"):
        assert getattr(got, f) == getattr(want, f), f
    pos = got.pos.numpy()
    ri = got.row_items.numpy()
    assert ri.shape == (tg.n_nodes + 2,) and ri[-1] == len(pos)
    for r in range(tg.n_nodes + 1):
        assert (pos[ri[r] : ri[r + 1]] == r).all()


def test_stream_from_numpy_carries_graphtpu_stream():
    tg, jg = _pair(weighted=True)
    js = jspmm.build_spmv_segments(jg, weighted=True, block_items=16, k=2)
    ts = stream_from_numpy(
        np.asarray(js.slots), np.asarray(js.wts), np.asarray(js.pos),
        np.asarray(js.raw_wts), np.asarray(js.scales), js.n_nodes, js.n_items,
        js.block_items, js.uniform, js.seg_k,
    )
    own = tspmm.build_spmv_segments(tg, weighted=True, block_items=16, k=2)
    for f in ("slots", "wts", "pos", "raw_wts", "scales", "row_items"):
        assert torch.equal(getattr(ts, f), getattr(own, f)), f


def _pallas(js, x, mode, table_scale):
    v, c = js.n_nodes, x.shape[1]
    out = jspmm.spmv_pallas_flat(
        js, jnp.asarray(x).reshape(-1), c, interpret=True, mode=mode,
        table_scale=table_scale,
    )
    return np.asarray(out.astype(jnp.float32)).reshape(v + 1, c)


def _pin(x, c):
    """float64 where(col == row, 1, c*x) over the table rows."""
    t = c * np.asarray(x, np.float64)
    n = min(t.shape)
    t[np.arange(n), np.arange(n)] = 1.0
    return t


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("table_scale", [None, 0.6])
@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_plain_matches_pallas_interpret_and_oracle(mode, table_scale, k):
    tg, jg = _pair(v=40, e=300)
    rng = np.random.default_rng(5)
    x = rng.random((40, C)).astype(np.float32)
    js = _plan(jspmm, jg, False, 16, k)
    ts = _plan(tspmm, tg, False, 16, k)
    got = tspmm.spmv_plain(ts, torch.from_numpy(x), mode, table_scale).numpy()
    assert got.shape == (41, C) and got.dtype == np.float32
    # f32 sums taken in another order: 1e-5 absolute on values <= 1
    np.testing.assert_allclose(got, _pallas(js, x, mode, table_scale), atol=1e-5)
    table = x if table_scale is None else _pin(x, table_scale)
    np.testing.assert_allclose(got[:40], tspmm.spmm_oracle(tg, table), atol=1e-5)
    assert not got[39].any() and not got[40].any()  # isolated and dummy rows


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_plain_weighted_matches_pallas_interpret(mode):
    tg, jg = _pair(v=36, e=200, weighted=True)
    rng = np.random.default_rng(7)
    x = rng.random((36, C)).astype(np.float32)
    ts = tspmm.build_spmv_stream(tg, weighted=True, block_items=16)
    js = jspmm.build_spmv_stream(jg, weighted=True, block_items=16)
    assert not ts.uniform
    got = tspmm.spmv(ts, torch.from_numpy(x), mode, 0.6).numpy()
    np.testing.assert_allclose(got, _pallas(js, x, mode, 0.6), atol=1e-5)
    np.testing.assert_allclose(
        got[:36], tspmm.spmm_oracle(tg, _pin(x, 0.6), weighted=True), atol=1e-5
    )


def _bf16_ulp(a):
    """One bf16 ulp at the magnitude of each entry (8 significant bits)."""
    a = np.abs(a)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-38))) - 7), 0.0)


@pytest.mark.parametrize("k", [1, 2])
def test_fast_bf16_within_one_ulp(k):
    tg, jg = _pair(v=40, e=300)
    rng = np.random.default_rng(9)
    xb = torch.from_numpy(rng.random((40, C)).astype(np.float32)).bfloat16()
    ts = _plan(tspmm, tg, False, 16, k)
    js = _plan(jspmm, jg, False, 16, k)
    got = tspmm.spmv(ts, xb, "fast", 0.6)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = _pallas(js, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), "fast", 0.6)
    bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= bound).all()
    oracle = tspmm.spmm_oracle(tg, _pin(xb.float().numpy(), 0.6))
    assert (np.abs(got[:40] - oracle) <= _bf16_ulp(oracle)).all()


def test_kahan_rejects_bf16_and_bad_modes():
    tg, _ = _pair(v=40, e=300)
    ts = tspmm.build_spmv_stream(tg)
    xb = torch.zeros((40, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="kahan"):
        tspmm.spmv(ts, xb, "kahan")
    with pytest.raises(ValueError):
        tspmm.spmv(ts, xb.float(), "exact")
    with pytest.raises(TypeError):
        tspmm.spmv(ts, xb.double(), "fast")


def test_cpu_spmv_counts_no_launch_and_other_devices_raise():
    tg, _ = _pair(v=40, e=300)
    ts = tspmm.build_spmv_stream(tg)
    before = dict(tspmm.SPMV_LAUNCHES)
    x = torch.rand((40, 33), generator=torch.Generator().manual_seed(0))
    for mode in ("kahan", "fast"):
        tspmm.spmv(ts, x, mode)
        tspmm.spmv(ts, x, mode, table_scale=0.6)
    assert tspmm.SPMV_LAUNCHES == before
    with pytest.raises(RuntimeError, match="no spmv kernel"):
        tspmm.spmv(ts, torch.empty((40, 33), device="meta"), "kahan")


def test_plain_column_blocks_and_ragged_width(monkeypatch):
    tg, _ = _pair()
    ts = tspmm.build_spmv_segments(tg, block_items=64, k=2)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((67, 77)).astype(np.float32))
    whole = tspmm.spmv_plain(ts, x, "kahan", 0.6)
    monkeypatch.setattr(tspmm, "_PLAIN_TEMP_ELEMS", 5 * ts.slots.numel())
    blocked = tspmm.spmv_plain(ts, x, "kahan", 0.6)  # 15 blocks of 5 + one of 2
    assert torch.equal(whole, blocked)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'spmv.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="error: broken"):
        _build.load()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    assert os.path.basename(str(_build.library_path())).startswith("libgraphtpu_torch_kernels-")
