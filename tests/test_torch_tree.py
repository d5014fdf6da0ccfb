"""graphtpu_torch reduction-tree products: plans bit-equal to graphtpu's,
the plain version of kernel B3 against graphtpu's XLA level primitive and
its Pallas kernel (interpret mode), ``tree_spmm`` and the tree branch of
``exact_simrank_spmm`` against graphtpu's ``impl="xla"`` forms and the
numpy oracles, and the dispatch rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.core.config import SimRankConfig as JConfig
from graphtpu.core.graph import host_csr
from graphtpu.kernels import spmm as jspmm
from graphtpu.simrank import exact as jexact
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.convert import graph_from_numpy, tree_from_numpy
from graphtpu_torch.kernels import spmm as tspmm
from graphtpu_torch.simrank import exact as texact

torch.set_num_threads(1)


def _edges(v=67, e=600, seed=0, weighted=False, hub=True):
    """tests/test_spmm.py's graph: a hub row of degree v-2 (> W², so at
    least three levels) and an isolated last node."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    if hub:
        hub_edges = np.stack([np.zeros(v - 2, np.int64), np.arange(1, v - 1)], 1)
        edges = np.concatenate([edges, hub_edges])
    edges = edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    return edges, wts


def _pair(weighted=False, hub=True):
    edges, wts = _edges(weighted=weighted, hub=hub)
    return (
        gt.build_graph(edges, weights=wts, n_nodes=67),
        graphtpu.build_graph(edges, weights=wts, n_nodes=67),
    )


def to_torch(jg):
    if isinstance(jg, graphtpu.DiGraph):
        return gt.DiGraph(out=to_torch(jg.out), in_=to_torch(jg.in_))
    return graph_from_numpy(*(None if a is None else np.asarray(a) for a in host_csr(jg)))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.tobytes()


def _assert_same_tree(got, want):
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels + got.weights, want.levels + want.weights):
        assert _bits(a.numpy()) == _bits(np.asarray(b))
    assert got.real_rows == want.real_rows
    assert (got.width, got.n_nodes) == (want.width, want.n_nodes)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_plan_matches_graphtpu_bitwise(width, weighted):
    tg, jg = _pair(weighted=weighted)
    got = tspmm.build_reduction_tree(tg, width=width, weighted=weighted)
    want = jspmm.build_reduction_tree(jg, width=width, weighted=weighted)
    assert len(got.levels) >= 3  # hub degree > width**2
    _assert_same_tree(got, want)
    assert all(l.shape[0] % 256 == 0 for l in got.levels)


def test_plan_row_scale_matches_graphtpu_bitwise():
    tg, jg = _pair(weighted=True)
    scale = np.random.default_rng(3).random(67).astype(np.float32)
    got = tspmm.build_reduction_tree(tg, weighted=True, block=16, row_scale=scale)
    want = jspmm.build_reduction_tree(jg, weighted=True, block=16, row_scale=scale)
    _assert_same_tree(got, want)
    with pytest.raises(ValueError, match="row_scale"):
        tspmm.build_reduction_tree(tg, row_scale=scale[:5])


def _level_inputs(m=256, w=8, n=50, c=1024, seed=3):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, (m, w)).astype(np.int32),
        rng.random((m, w)).astype(np.float32),
        rng.random((n, c)).astype(np.float32),
    )


def test_gather_plain_bit_equal_to_xla_and_pallas_interpret():
    slots, wts, table = _level_inputs()
    got = tspmm.gather_rows_sum_plain(
        torch.from_numpy(slots), torch.from_numpy(wts), torch.from_numpy(table)
    ).numpy()
    xla = np.asarray(jspmm.gather_rows_sum_xla(
        jnp.asarray(slots), jnp.asarray(wts), jnp.asarray(table)))
    pallas = np.asarray(jspmm.gather_rows_sum_pallas(
        jnp.asarray(slots), jnp.asarray(wts), jnp.asarray(table), interpret=True))
    # the same products and adds in the same order: bit-equal
    assert _bits(got) == _bits(xla)
    assert _bits(got) == _bits(pallas)


def test_gather_plain_bf16_table_gives_f32_like_xla():
    slots, wts, table = _level_inputs(m=64, w=4, n=30, c=96)
    tb = torch.from_numpy(table).bfloat16()
    got = tspmm.gather_rows_sum_plain(torch.from_numpy(slots), torch.from_numpy(wts), tb)
    assert got.dtype == torch.float32
    want = jspmm.gather_rows_sum_xla(
        jnp.asarray(slots), jnp.asarray(wts),
        jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.float32
    # bf16 values are exact in f32, so the f32 sums match bit for bit
    assert _bits(got.numpy()) == _bits(np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_tree_spmm_matches_graphtpu_and_oracle(width, weighted):
    tg, jg = _pair(weighted=weighted)
    x = np.random.default_rng(1).random((67, 33)).astype(np.float32)
    tree = tspmm.build_reduction_tree(tg, width=width, weighted=weighted)
    got = tspmm.tree_spmm(tree, torch.from_numpy(x)).numpy()
    jtree = jspmm.build_reduction_tree(jg, width=width, weighted=weighted)
    want = np.asarray(jspmm.tree_spmm(jtree, jnp.asarray(x), impl="xla"))
    assert got.shape == (67, 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)  # same sum order
    # float64 oracle: f32 tree sums against exact ones, values <= 1
    np.testing.assert_allclose(got, tspmm.spmm_oracle(tg, x, weighted=weighted), atol=1e-5)
    assert not got[66].any()  # isolated node -> zero row


def test_tree_spmm_column_blocks_and_ragged_tail():
    tg, jg = _pair(hub=False)
    x = np.random.default_rng(2).random((67, 70)).astype(np.float32)  # 2*32 + 6
    tree = tspmm.build_reduction_tree(tg)
    got = tspmm.tree_spmm(tree, torch.from_numpy(x), col_block=32).numpy()
    want = np.asarray(jspmm.tree_spmm(
        jspmm.build_reduction_tree(jg), jnp.asarray(x), col_block=32, impl="xla"))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, tspmm.spmm_oracle(tg, x), atol=1e-5)
    whole = tspmm.tree_spmm(tree, torch.from_numpy(x)).numpy()
    assert _bits(got) == _bits(whole)  # columns are independent


def test_tree_from_numpy_carries_graphtpu_tree():
    tg, jg = _pair(weighted=True)
    jt = jspmm.build_reduction_tree(jg, width=4, weighted=True)
    carried = tree_from_numpy(
        [np.asarray(l) for l in jt.levels], [np.asarray(w) for w in jt.weights],
        jt.width, jt.n_nodes, jt.real_rows,
    )
    own = tspmm.build_reduction_tree(tg, width=4, weighted=True)
    x = torch.from_numpy(np.random.default_rng(4).random((67, 40)).astype(np.float32))
    assert torch.equal(tspmm.tree_spmm(carried, x), tspmm.tree_spmm(own, x))


def _weighted_graph():
    rng = np.random.default_rng(6)
    edges = rng.integers(0, 30, size=(110, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    wts = rng.random(len(edges)).astype(np.float32) * 3 + 0.1
    return graphtpu.build_graph(edges, wts, n_nodes=32)


def _digraph():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 24, size=(90, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return graphtpu.build_graph(edges, n_nodes=24, directed=True)


def _bf16_ulp(a):
    a = np.abs(a)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-38))) - 7), 0.0)


@pytest.mark.parametrize("case", ["unweighted", "weighted", "directed"])
@pytest.mark.parametrize("width,col_block", [(8, 4096), (4, 48)])
def test_simrank_tree_matches_graphtpu_xla(small_random, case, width, col_block):
    jg = {"unweighted": small_random, "weighted": _weighted_graph(),
          "directed": _digraph()}[case]
    weighted = case == "weighted"
    got = texact.exact_simrank_spmm(
        to_torch(jg), SimRankConfig(iterations=4), weighted=weighted,
        impl="tree", width=width, col_block=col_block, device="cpu")
    want = np.asarray(jexact.exact_simrank_spmm(
        jg, JConfig(iterations=4), weighted=weighted, impl="xla",
        width=width, col_block=col_block))
    assert got.dtype == torch.float32
    # the same f32 operations in the same order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_simrank_tree_bf16_within_one_ulp_of_graphtpu(small_random):
    got = texact.exact_simrank_spmm(
        to_torch(small_random), SimRankConfig(iterations=3), dtype=torch.bfloat16,
        impl="tree", device="cpu")
    want = jexact.exact_simrank_spmm(
        small_random, JConfig(iterations=3), dtype=jnp.bfloat16, impl="xla")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def test_simrank_tree_matches_oracle_and_stream(small_random):
    g = to_torch(small_random)
    cfg = SimRankConfig(iterations=3)
    tree = texact.exact_simrank_spmm(g, cfg, impl="tree", device="cpu").numpy()
    oracle = texact.exact_simrank_reference_oracle(g, c=0.6, iterations=3)
    np.testing.assert_allclose(tree, oracle, atol=2e-5)
    stream = texact.exact_simrank_spmm(g, cfg, device="cpu").numpy()  # the stream branch
    np.testing.assert_allclose(tree, stream, atol=2e-5)


def test_simrank_tree_weighted_and_directed_match_oracles():
    jw = _weighted_graph()
    got = texact.exact_simrank_spmm(
        to_torch(jw), SimRankConfig(iterations=4), weighted=True, impl="tree", device="cpu")
    want = texact.weighted_simrank_reference_oracle(to_torch(jw), c=0.6, iterations=4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    jd = _digraph()
    got = texact.exact_simrank_spmm(to_torch(jd), SimRankConfig(iterations=4), impl="tree",
                                    device="cpu")
    want = texact.directed_simrank_reference_oracle(to_torch(jd), c=0.6, iterations=4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_simrank_tree_stage_times_and_bad_impl(small_random):
    g = to_torch(small_random)
    times = {}
    texact.exact_simrank_spmm(g, SimRankConfig(iterations=2), impl="tree",
                              stage_times=times, device="cpu")
    assert set(times) == {"product1", "transpose", "product2", "layout_host", "plan"}
    assert all(t >= 0 for t in times.values())
    assert times["layout_host"] == 0.0  # no compact plans on the CPU
    with pytest.raises(ValueError, match="impl"):
        texact.exact_simrank_spmm(g, impl="xla", device="cpu")


@pytest.mark.parametrize("kw", [{"spmv_mode": "fast"}, {"spmv_seg": 2}])
def test_simrank_tree_rejects_stream_options(small_random, kw):
    with pytest.raises(ValueError, match="impl='tree' takes neither"):
        texact.exact_simrank_spmm(to_torch(small_random), impl="tree", device="cpu", **kw)


def test_gather_dispatch_counts_no_cpu_launch_and_checks_inputs():
    slots, wts, table = (torch.from_numpy(a) for a in _level_inputs(m=32, w=4, n=20, c=40))
    before = dict(tspmm.GATHER_LAUNCHES)
    out = torch.full((32, 40), float("nan"))
    got = tspmm.gather_rows_sum(slots, wts, table, out=out)
    assert got is out
    assert torch.equal(out, tspmm.gather_rows_sum_plain(slots, wts, table))
    block = torch.zeros((32, 100))
    tspmm.gather_rows_sum(slots, wts, table[:, 5:25], out=block[:, 10:30])
    assert torch.equal(block[:, 10:30], out[:, 5:25]) and not block[:, :10].any()
    assert tspmm.GATHER_LAUNCHES == before
    with pytest.raises(TypeError, match="slots"):
        tspmm.gather_rows_sum(slots.long(), wts, table)
    with pytest.raises(TypeError, match="table"):
        tspmm.gather_rows_sum(slots, wts, table.double())
    with pytest.raises(ValueError, match="out"):
        tspmm.gather_rows_sum(slots, wts, table, out=torch.empty((32, 39)))
    with pytest.raises(RuntimeError, match="no gather kernel"):
        tspmm.gather_rows_sum(slots.to("meta"), wts.to("meta"), table.to("meta"))
