"""graphtpu_torch exact SimRank, dense and streaming-sparse, against
graphtpu (the sparse loop through its Pallas kernels in interpret mode)
and the float64 oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.core.config import SimRankConfig as JConfig
from graphtpu.core.graph import host_csr
from graphtpu.simrank import exact as jexact
from graphtpu_torch.core.config import SimRankConfig, WeightedSimRankConfig
from graphtpu_torch.core.convert import graph_from_numpy
from graphtpu_torch.simrank import exact as texact

torch.set_num_threads(1)


def to_torch(jg):
    if isinstance(jg, graphtpu.DiGraph):
        return gt.DiGraph(out=to_torch(jg.out), in_=to_torch(jg.in_))
    return graph_from_numpy(*(None if a is None else np.asarray(a) for a in host_csr(jg)))


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


@pytest.mark.parametrize("case", ["unweighted", "weighted", "directed"])
def test_dense_matches_graphtpu(case, small_random):
    jg = {"unweighted": small_random, "weighted": _weighted_graph(),
          "directed": _digraph()}[case]
    weighted = case == "weighted"
    got = texact.exact_simrank(to_torch(jg), SimRankConfig(iterations=4),
                               weighted=weighted, device="cpu")
    want = jexact.exact_simrank(jg, JConfig(iterations=4), weighted=weighted)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_dense_matches_reference_oracle(small_random):
    g = to_torch(small_random)
    got = texact.exact_simrank(g, SimRankConfig(iterations=3), device="cpu").numpy()
    want = texact.exact_simrank_reference_oracle(g, c=0.6, iterations=3)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(
        want, jexact.exact_simrank_reference_oracle(small_random, 0.6, 3)
    )


def test_dense_isolated_node_matches_oracle():
    g = gt.build_graph(np.array([[0, 1], [1, 2], [3, 1]]), n_nodes=5)
    got = texact.exact_simrank(g, SimRankConfig(iterations=4), device="cpu").numpy()
    want = texact.exact_simrank_reference_oracle(g, c=0.6, iterations=4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[4] == 0).all() and (got[:, 4] == 0).all()


def test_weighted_matches_weighted_oracle():
    jg = _weighted_graph()
    g = to_torch(jg)
    got = texact.weighted_simrank(g, WeightedSimRankConfig(iterations=5), device="cpu").numpy()
    want = texact.weighted_simrank_reference_oracle(g, c=0.6, iterations=5)
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_array_equal(
        want, jexact.weighted_simrank_reference_oracle(jg, 0.6, 5)
    )


def test_directed_matches_directed_oracle():
    jg = _digraph()
    g = to_torch(jg)
    got = texact.exact_simrank(g, SimRankConfig(iterations=4), device="cpu").numpy()
    want = texact.directed_simrank_reference_oracle(g, c=0.6, iterations=4)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(
        want, jexact.directed_simrank_reference_oracle(jg, 0.6, 4)
    )


@pytest.mark.parametrize(
    "mode,seg", [("kahan", 1), ("fast", 1), ("kahan", 2), ("fast", 2)]
)
def test_spmm_matches_graphtpu_pallas_interpret(small_random, mode, seg):
    cfg = SimRankConfig(iterations=3)
    got = texact.exact_simrank_spmm(
        to_torch(small_random), cfg, spmv_mode=mode, spmv_seg=seg, device="cpu"
    )
    want = jexact.exact_simrank_spmm(
        small_random, JConfig(iterations=3), impl="pallas", spmv_mode=mode,
        interpret=True, spmv_seg=seg,
    )
    assert got.shape == (64, 64) and got.dtype == torch.float32
    # the tolerance of tests/test_spmm.py:153 and :227 (sum orders differ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    dense = texact.exact_simrank(to_torch(small_random), cfg, device="cpu").numpy()
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-5)


@pytest.mark.parametrize("mode", ["kahan", "fast"])
def test_spmm_weighted_and_directed_match_dense(mode):
    for jg, weighted in ((_weighted_graph(), True), (_digraph(), False)):
        g = to_torch(jg)
        cfg = SimRankConfig(iterations=4)
        dense = texact.exact_simrank(g, cfg, weighted=weighted, device="cpu").numpy()
        sparse = texact.exact_simrank_spmm(g, cfg, weighted=weighted, spmv_mode=mode,
                                            device="cpu")
        np.testing.assert_allclose(sparse.numpy(), dense, atol=2e-5)


def test_fast16_matches_gold_ranking(small_random):
    g = to_torch(small_random)
    cfg = SimRankConfig(iterations=4)
    gold = texact.exact_simrank(g, cfg, device="cpu").numpy()
    a16 = texact.exact_simrank_spmm(g, cfg, spmv_mode="fast", dtype=torch.bfloat16,
                                   device="cpu")
    assert a16.dtype == torch.bfloat16
    a16 = a16.float().numpy()
    assert np.abs(a16 - gold).max() < 1e-2
    agree = [
        len(set(np.argsort(-gold[r])[:10]) & set(np.argsort(-a16[r])[:10])) / 10
        for r in range(0, 64, 5)
    ]
    assert np.mean(agree) >= 0.95, np.mean(agree)


def test_spmm_stage_times_and_topk(small_random):
    g = to_torch(small_random)
    times = {}
    sim = texact.exact_simrank_spmm(g, SimRankConfig(iterations=2), stage_times=times,
                                    device="cpu")
    assert set(times) == {"product1", "transpose", "product2", "layout_host", "plan",
                          "stream_host"}
    assert all(t >= 0 for t in times.values())
    assert times["plan"] >= times["stream_host"] + times["layout_host"]
    vals, idx = texact.simrank_topk(sim, 5)
    jvals, jidx = jexact.simrank_topk(jnp.asarray(sim.numpy()), 5)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(idx, jidx)


@pytest.mark.parametrize("entry", ["exact_simrank", "exact_simrank_spmm", "weighted_simrank"])
def test_entry_points_default_to_the_card(entry, small_random, monkeypatch):
    """A host-built graph runs on ``cuda`` unless ``device="cpu"`` is given;
    without a card that raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = to_torch(small_random)
    assert g.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(texact, entry)(g)
