"""graphtpu_torch's 2-D SUMMA SimRank against graphtpu's.

graphtpu runs on 4 of tests/conftest.py's 8 virtual CPU devices; the port
in 4 gloo ranks on the CPU, spawned once for the module (see
tests/test_torch_dist.py for the arrangement and why jax and graphtpu are
imported inside the tests).  The plans are compared exactly, the float32
scores at 1e-6 against graphtpu's at the same grid (the c partials are
summed in another order) and 1e-5 against the dense fp32 engine, bf16
iterates within 3 bf16 ulps of graphtpu's at each entry (the reason is
in test_torch_dist.py's docstring)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphtpu_torch import build_graph
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.graph import pad_graph_nodes
from graphtpu_torch.dist import mesh as tm
from graphtpu_torch.dist.spmm_summa import build_summa_plan
from graphtpu_torch.simrank.exact import exact_simrank

torch.set_num_threads(1)
N_RANKS = 4
GRIDS = [(1, 4), (2, 2), (4, 1)]
TOL_F32 = 1e-6
TOL_DENSE = 1e-5
BF16_ULPS = 3


def ring_edges(v):
    return np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)


def small_edges():
    """tests/conftest.py's ``small_random``."""
    rng = np.random.default_rng(42)
    edges = rng.integers(0, 64, size=(400, 2))
    return np.concatenate([edges[edges[:, 0] != edges[:, 1]], ring_edges(64)])


def weighted_inputs():
    """tests/test_summa.py's weighted graph: 40 nodes."""
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 40, size=(150, 2))
    edges = np.concatenate([edges[edges[:, 0] != edges[:, 1]], ring_edges(40)])
    return edges, rng.random(len(edges)).astype(np.float32) + 0.1


def directed_edges():
    """tests/test_summa.py's directed graph: 32 nodes."""
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 32, size=(200, 2))
    return edges[edges[:, 0] != edges[:, 1]]


def _rank_cases(device):
    from graphtpu_torch.dist.spmm_sharded import gather_sim
    from graphtpu_torch.dist.spmm_summa import summa_simrank_spmm

    out = {}
    cfg = SimRankConfig(iterations=3)
    small = build_graph(small_edges(), n_nodes=64)
    world = tm.make_1d_mesh(device=device).groups["data"]
    for r, c in GRIDS:
        mesh = tm.make_2d_mesh(r, c, device=device)
        blk = summa_simrank_spmm(small, mesh, cfg)
        out[f"grid_{r}x{c}"] = gather_sim(blk).numpy()
        out[f"shapes_{r}x{c}"] = tm.all_gather(torch.tensor(blk.values.shape), world).numpy()
    mesh = tm.make_2d_mesh(2, 2, device=device)
    e, w = weighted_inputs()
    out["weighted"] = gather_sim(summa_simrank_spmm(build_graph(e, w, n_nodes=40), mesh, cfg,
                                                    weighted=True)).numpy()
    out["directed"] = gather_sim(summa_simrank_spmm(
        build_graph(directed_edges(), n_nodes=32, directed=True), mesh, cfg)).numpy()
    b16 = summa_simrank_spmm(small, mesh, cfg, dtype=torch.bfloat16)
    out["bf16"] = (b16.values.dtype, gather_sim(b16).float().numpy())
    return out


@pytest.fixture(scope="module")
def ranks():
    return tm.spawn(_rank_cases, N_RANKS, "gloo", "cpu", timeout=600)


@pytest.fixture(scope="module")
def gt():
    import jax.numpy as jnp

    import graphtpu
    from graphtpu.core.config import SimRankConfig as JSimRankConfig
    from graphtpu.dist import spmm_summa

    return SimpleNamespace(jnp=jnp, graphtpu=graphtpu, cfg=JSimRankConfig(iterations=3),
                           summa=spmm_summa)


def assert_bf16_close(got, want):
    """|got - want| within BF16_ULPS bf16 ulps of each entry of ``want``."""
    _, e = np.frexp(np.abs(want).astype(np.float64))
    ulp = np.where(want != 0, np.ldexp(1.0, e - 8), 0.0)
    np.testing.assert_array_less(np.abs(got - want), BF16_ULPS * ulp + 1e-9)


def dense(g, weighted=False):
    return exact_simrank(g, SimRankConfig(iterations=3), weighted=weighted, device="cpu").numpy()


@pytest.mark.parametrize("r,c", GRIDS)
def test_summa_plan_equals_graphtpu(gt, r, c):
    v = -(-64 // (r * c * 8)) * (r * c * 8)
    jg = gt.graphtpu.core.graph.pad_graph_nodes(gt.graphtpu.build_graph(small_edges(),
                                                                         n_nodes=64), v)
    want = gt.summa.build_summa_plan(jg, r, c)
    got = build_summa_plan(pad_graph_nodes(build_graph(small_edges(), n_nodes=64), v), r, c)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels + got.weights, want.levels + want.weights):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    # level 0 indexes inside the local k-block, and the plan ends at V/r rows
    assert got.levels[0].max() < v // c
    assert got.levels[-1].shape[2] >= v // r


def test_weighted_summa_plan_equals_graphtpu(gt):
    e, w = weighted_inputs()
    want = gt.summa.build_summa_plan(gt.graphtpu.build_graph(e, w, n_nodes=40), 2, 2,
                                     weighted=True)
    got = build_summa_plan(build_graph(e, w, n_nodes=40), 2, 2, weighted=True)
    for a, b in zip(got.levels + got.weights, want.levels + want.weights):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("r,c", GRIDS)
def test_summa_equals_graphtpu(gt, ranks, r, c):
    want = np.asarray(gt.summa.summa_simrank_spmm(
        gt.graphtpu.build_graph(small_edges(), n_nodes=64), gt.summa.make_2d_mesh(r, c), gt.cfg))
    got = ranks[f"grid_{r}x{c}"]
    np.testing.assert_allclose(got, want, atol=TOL_F32)
    np.testing.assert_allclose(got, dense(build_graph(small_edges(), n_nodes=64)), atol=TOL_DENSE)


@pytest.mark.parametrize("r,c", GRIDS)
def test_summa_blocks_are_blocked(ranks, r, c):
    """Each rank holds one [V/c, V/r] block (V = 64 needs no padding at 4
    ranks), never the whole [V, V]."""
    shapes = ranks[f"shapes_{r}x{c}"]
    assert (shapes == [64 // c, 64 // r]).all()


def test_weighted_summa_equals_graphtpu(gt, ranks):
    e, w = weighted_inputs()
    want = np.asarray(gt.summa.summa_simrank_spmm(gt.graphtpu.build_graph(e, w, n_nodes=40),
                                                  gt.summa.make_2d_mesh(2, 2), gt.cfg,
                                                  weighted=True))
    np.testing.assert_allclose(ranks["weighted"], want, atol=TOL_F32)
    np.testing.assert_allclose(ranks["weighted"], dense(build_graph(e, w, n_nodes=40), True),
                               atol=TOL_DENSE)


def test_directed_summa_equals_graphtpu(gt, ranks):
    want = np.asarray(gt.summa.summa_simrank_spmm(
        gt.graphtpu.build_graph(directed_edges(), n_nodes=32, directed=True),
        gt.summa.make_2d_mesh(2, 2), gt.cfg))
    np.testing.assert_allclose(ranks["directed"], want, atol=TOL_F32)
    np.testing.assert_allclose(
        ranks["directed"], dense(build_graph(directed_edges(), n_nodes=32, directed=True)),
        atol=TOL_DENSE)


def test_bf16_summa_equals_graphtpu(gt, ranks):
    jnp = gt.jnp
    want = np.asarray(gt.summa.summa_simrank_spmm(
        gt.graphtpu.build_graph(small_edges(), n_nodes=64), gt.summa.make_2d_mesh(2, 2), gt.cfg,
        dtype=jnp.bfloat16).astype(jnp.float32))
    dtype, got = ranks["bf16"]
    assert dtype == torch.bfloat16
    assert_bf16_close(got, want)
    f32 = dense(build_graph(small_edges(), n_nodes=64))
    np.testing.assert_allclose(got, f32, atol=0.02)
    agree = sum(len(set(np.argsort(-f32[i])[:5]) & set(np.argsort(-got[i])[:5]))
                for i in range(64))
    assert agree / (5 * 64) > 0.9
