"""graphtpu_torch's SpMV item-rate probe: the plain versions of kernels
X1-X3 against graphtpu's X3 (tools/exp_spmv_rate.py, interpret mode) and
numpy forms of X1's and X2's stated outputs, the wrappers' dispatch rules
and the probe's arguments."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.kernels import spmm as jspmm
from graphtpu_torch.bench import generators, spmv_rate
from graphtpu_torch.kernels import spmm as tspmm

torch.set_num_threads(1)

V, C = 64, 128
TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools", "exp_spmv_rate.py")


def _edges(v=V, e=300, seed=0):
    """A hub row of degree v-2 and an isolated last node (a dummy item)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    hub = np.stack([np.zeros(v - 2, np.int64), np.arange(1, v - 1)], 1)
    edges = np.concatenate([edges, hub])
    return edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]


def _stream(block_items=16):
    return tspmm.build_spmv_stream(gt.build_graph(_edges(), n_nodes=V),
                                   block_items=block_items)


def _table(seed=1, rows=V):
    return np.random.default_rng(seed).random((rows, C)).astype(np.float32)


def _row_items(stream):
    return stream.row_items.numpy()


def test_x3_plain_matches_graphtpu_x3_interpret():
    spec = importlib.util.spec_from_file_location("exp_spmv_rate", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.INTERP = True
    js = jspmm.build_spmv_stream(graphtpu.build_graph(_edges(), n_nodes=V), block_items=16)
    x = _table()
    want = np.asarray(tool.variant_call(
        tool._fast_unroll_kernel, js, jnp.asarray(x).reshape(-1), C, 16)).reshape(V + 1, C)
    ts = _stream(16)
    got = spmv_rate.unroll8_plain(ts, torch.from_numpy(x)).numpy()
    ri = _row_items(ts)
    has = np.flatnonzero(ri[1:] > ri[:-1])  # rows the TPU kernel writes
    assert len(has) >= V
    # raw sums in item order on both sides; bound 1e-6 of Σ|terms| per entry
    bound = 1e-6 * spmv_rate.unroll8_plain(ts, torch.from_numpy(np.abs(x))).numpy()
    assert (np.abs(got[has] - want[has]) <= bound[has]).all()


def test_x1_plain_is_the_row_max_of_its_items():
    ts = _stream()
    x = _table(2)
    got = spmv_rate.gather_only_plain(ts, torch.from_numpy(x)).numpy()
    slots, ri = ts.slots.numpy(), _row_items(ts)
    want = np.zeros((V + 1, C), np.float32)
    for r in range(V + 1):
        if ri[r + 1] > ri[r]:
            want[r] = x[slots[ri[r]:ri[r + 1]]].max(0)
    assert np.array_equal(got, want)  # a max is exact


def test_x2_plain_is_the_weighted_sum_over_the_buffer():
    ts = _stream()
    buf = np.random.default_rng(3).random((spmv_rate.N_BUF, C)).astype(np.float32)
    got = spmv_rate.accumulate_only_plain(ts, torch.from_numpy(buf)).numpy()
    wts, ri = ts.wts.numpy().astype(np.float64), _row_items(ts)
    want = np.zeros((V + 1, C))
    for r in range(V + 1):
        t = np.arange(ri[r], ri[r + 1])
        want[r] = (wts[t, None] * buf[t % spmv_rate.N_BUF]).sum(0)
    # f32 sums against float64; all terms are >= 0, so Σ|terms| = want
    assert (np.abs(got - want) <= 1e-6 * want + 1e-30).all()


def test_plain_column_blocks_give_the_same_result(monkeypatch):
    ts = _stream()
    x = torch.from_numpy(_table(4))
    buf = torch.from_numpy(_table(5, rows=spmv_rate.N_BUF))
    whole = [spmv_rate.gather_only_plain(ts, x), spmv_rate.unroll8_plain(ts, x),
             spmv_rate.accumulate_only_plain(ts, buf)]
    monkeypatch.setattr(tspmm, "_PLAIN_TEMP_ELEMS", 7 * ts.slots.numel())
    blocked = [spmv_rate.gather_only_plain(ts, x), spmv_rate.unroll8_plain(ts, x),
               spmv_rate.accumulate_only_plain(ts, buf)]  # 18 blocks of 7 + one of 2
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_wrappers_run_plain_on_cpu_without_counting_and_check_inputs():
    ts = _stream()
    x = torch.from_numpy(_table(6))
    buf = torch.from_numpy(_table(7, rows=spmv_rate.N_BUF))
    before = dict(spmv_rate.RATE_LAUNCHES)
    assert torch.equal(spmv_rate.gather_only(ts, x), spmv_rate.gather_only_plain(ts, x))
    assert torch.equal(spmv_rate.unroll8(ts, x), spmv_rate.unroll8_plain(ts, x))
    assert torch.equal(spmv_rate.accumulate_only(ts, buf),
                       spmv_rate.accumulate_only_plain(ts, buf))
    assert spmv_rate.RATE_LAUNCHES == before
    with pytest.raises(TypeError, match="float32"):
        spmv_rate.unroll8(ts, x.bfloat16())
    with pytest.raises(ValueError, match="rows"):
        spmv_rate.gather_only(ts, x[:10])
    with pytest.raises(ValueError, match="seg_k"):
        seg = tspmm.build_spmv_segments(gt.build_graph(_edges(), n_nodes=V), k=2)
        spmv_rate.unroll8(seg, x)
    with pytest.raises(RuntimeError, match="no unroll8 kernel"):
        spmv_rate.unroll8(ts, x.to("meta"))


@pytest.mark.parametrize("name", sorted(spmv_rate.RATE_LAUNCHES))
def test_design_follows_the_stream_layout(name):
    """Every rate kernel runs B2's design: the column panel over a stream
    with a sliced layout, row tiles without one."""
    ts = _stream()
    assert ts.layout is None and spmv_rate.design(name, ts) == "rows"
    laid = tspmm.with_layout(ts, tspmm.build_sell_layout(ts))
    assert spmv_rate.design(name, laid) == "panel"
    with pytest.raises(ValueError, match="unknown rate kernel"):
        spmv_rate.design(name + "_x", laid)


def test_parse_args():
    assert spmv_rate.parse_args([]).out is None
    assert spmv_rate.parse_args(["--out", "r.json"]).out == "r.json"
    for bad in (["--graphs", "rmat"], ["--runs", "3"]):
        with pytest.raises(SystemExit):
            spmv_rate.parse_args(bad)


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        spmv_rate.main([])


def test_probe_graphs_have_the_stated_shapes():
    blog = generators.blog_shaped_graph()
    assert (blog.n_nodes, blog.n_edges, blog.max_degree) == (10_496, 657_924, 103)
    rmat = generators.rmat14_graph()
    assert (rmat.n_nodes, rmat.n_edges, rmat.max_degree) == (16_384, 521_320, 4_086)
