"""graphtpu_torch's walk engine against graphtpu's.

The two packages draw different random numbers (threefry against Philox),
so the deterministic pieces (cumulative weights, padded rows, membership,
panel widths, the exact transition law) are compared exactly and the walks
statistically: every transition an edge, dead ends -1, and next-hop
frequencies within a total-variation bound of the reference bias rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
from graphtpu.core.graph import padded_neighbors as j_padded_neighbors
from graphtpu.kernels import sampling as jsm
from graphtpu.walks import node2vec as jn2v
from graphtpu_torch import build_graph
from graphtpu_torch.core.graph import graph_from_numpy, padded_neighbors
from graphtpu_torch.kernels import sampling as tsm
from graphtpu_torch.kernels.edgeset import edge_set
from graphtpu_torch.walks import alias_sample, alias_setup
from graphtpu_torch.walks import node2vec as tn2v
from graphtpu_torch.walks.walker import simulate_walks, uniform_walks, walks_to_corpus

torch.set_num_threads(1)
CPU = "cpu"


def _port(jg):
    """The port's graph on graphtpu's CSR arrays."""
    w = None if jg.weight is None else np.asarray(jg.weight)
    return graph_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col), w, np.asarray(jg.deg))


@pytest.fixture(scope="module")
def small(small_random):
    return _port(small_random)


@pytest.fixture(scope="module")
def weighted_pair():
    rng = np.random.default_rng(6)
    edges = rng.integers(0, 40, size=(200, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    wts = (rng.random(len(edges)) + 0.1).astype(np.float32)
    jg = graphtpu.build_graph(edges, wts, n_nodes=41)  # node 40 isolated
    return jg, _port(jg)


@pytest.fixture(scope="module")
def karate_port():
    """The karate club (networkx, 34 nodes, 78 edges) shifted to the
    reference file's ids 1..34, so node 0 is isolated."""
    import networkx as nx

    edges = np.array(nx.karate_club_graph().edges()) + 1
    return build_graph(edges, n_nodes=35)


def _assert_valid(g, walks):
    """Every transition is an edge; -1 from the first dead step on."""
    rp, col, _, _ = g.host
    w = walks.cpu().numpy()
    for row in w:
        for t in range(w.shape[1] - 1):
            a, b = row[t], row[t + 1]
            if b < 0:
                assert (row[t + 1:] == -1).all()
                break
            assert b in col[rp[a]: rp[a + 1]], (a, b)


def test_row_cumulative_weights_matches(weighted_pair):
    """Against float64 row sums to 1e-6; against graphtpu, whose float32
    prefix over all E weights rounds at the scale of the graph's total
    weight, to 4 float32 ulps of that total."""
    jg, tg = weighted_pair
    got = tsm.row_cumulative_weights(tg).numpy()
    rp, _, w, deg = tg.host
    exact = np.concatenate([np.cumsum(w[rp[u]: rp[u + 1]].astype(np.float64))
                            for u in range(tg.n_nodes)])
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    total = float(w.astype(np.float64).sum())
    np.testing.assert_allclose(got, np.asarray(jsm.row_cumulative_weights(jg)),
                               rtol=0, atol=4 * np.finfo(np.float32).eps * total)


@pytest.mark.parametrize("weighted", [False, True])
def test_padded_neighbors_matches(weighted_pair, small_random, small, weighted):
    jg, tg = weighted_pair if weighted else (small_random, small)
    nb, nw = padded_neighbors(tg)
    jnb, jnw = j_padded_neighbors(jg)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    assert (nw is None) == (jnw is None)
    if weighted:
        np.testing.assert_array_equal(nw.numpy(), np.asarray(jnw))


def test_edge_exists_matches(weighted_pair, small_random, small):
    rng = np.random.default_rng(0)
    for jg, tg in (weighted_pair, (small_random, small)):
        v = tg.n_nodes
        u = rng.integers(-1, v, 300).astype(np.int32)
        w = rng.integers(0, v, 300).astype(np.int32)
        got = tsm.edge_exists(tg, torch.from_numpy(u), torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsm.edge_exists(jg, jnp.asarray(u), jnp.asarray(w))))
        rp, col, _, _ = tg.host
        assert got.tolist() == [a >= 0 and b in col[rp[a]: rp[a + 1]] for a, b in zip(u, w)]
        # broadcasting [B, 1] against [1, K]
        ub, wb = u[:20, None], w[None, :7]
        np.testing.assert_array_equal(
            tsm.edge_exists(tg, torch.from_numpy(ub), torch.from_numpy(wb)).numpy(),
            np.asarray(jsm.edge_exists(jg, jnp.asarray(ub), jnp.asarray(wb))))


def test_default_max_trials_matches():
    grid = [0.25, 0.5, 1.0, 2.0, 4.0]
    for p in grid:
        for q in grid:
            assert tn2v.default_max_trials(p, q) == jn2v.default_max_trials(p, q), (p, q)


def test_transition_probs_match(small_random, small, weighted_pair):
    for jg, tg in ((small_random, small), weighted_pair):
        rp, col, _, _ = tg.host
        for prev in (0, 3, 17):
            cur = int(col[rp[prev]])
            for p, q in ((0.25, 0.25), (4.0, 0.5), (1.0, 2.0)):
                np.testing.assert_allclose(
                    tn2v.node2vec_transition_probs(tg, prev, cur, p, q),
                    jn2v.node2vec_transition_probs(jg, prev, cur, p, q), atol=1e-12)


def test_uniform_walks_shape_and_validity(small):
    walks = uniform_walks(small, torch.arange(64, dtype=torch.int32), 10, 0, device=CPU)
    assert walks.shape == (64, 11) and walks.dtype == torch.int32
    _assert_valid(small, walks)


def test_dead_end_propagates_minus_one():
    g = build_graph(np.array([[0, 1]]), n_nodes=3, directed=True).out
    walks = uniform_walks(g, torch.tensor([0, 2], dtype=torch.int32), 4, 1, device=CPU)
    assert walks[0].tolist() == [0, 1, -1, -1, -1]  # 1 is a sink
    assert walks[1].tolist() == [2, -1, -1, -1, -1]  # isolated start


def test_uniform_neighbor_distribution(ring16):
    g = _port(ring16)
    gen = torch.Generator().manual_seed(2)
    nxt = tsm.uniform_neighbor(g, torch.zeros(4000, dtype=torch.int32), gen).numpy()
    counts = np.bincount(nxt, minlength=16)
    assert counts[1] + counts[15] == 4000
    assert abs(counts[1] / 4000 - 0.5) < 0.05


def test_weighted_neighbor_distribution():
    g = build_graph(np.array([[0, 1], [0, 2], [0, 3]]), np.array([1.0, 2.0, 5.0]), n_nodes=4)
    cumw = tsm.row_cumulative_weights(g)
    gen = torch.Generator().manual_seed(3)
    nxt = tsm.weighted_neighbor(g, cumw, torch.zeros(8000, dtype=torch.int32), gen).numpy()
    freq = np.bincount(nxt, minlength=4)[1:4] / 8000
    np.testing.assert_allclose(freq, [1 / 8, 2 / 8, 5 / 8], atol=0.03)


def test_sample_from_cdf_distribution():
    cdf = torch.cumsum(torch.tensor([1.0, 0.0, 3.0, 4.0]), 0)
    draws = tsm.sample_from_cdf(cdf, torch.Generator().manual_seed(4), (20000,))
    assert draws.dtype == torch.int32
    np.testing.assert_allclose(np.bincount(draws.numpy(), minlength=4) / 20000,
                               [1 / 8, 0, 3 / 8, 4 / 8], atol=0.02)


@pytest.mark.parametrize("mode", ["rejection", "exact"])
@pytest.mark.parametrize("pq", [(0.25, 0.25), (4.0, 0.5), (1.0, 2.0)])
def test_second_order_transition_statistics(small, mode, pq):
    """Empirical next-hop distribution == the reference get_alias_edge rule."""
    p, q = pq
    rp, col, _, deg = small.host
    prev = int(np.argmax(deg))
    cur = int(col[rp[prev]])
    n = 6000
    es = edge_set(small)
    prev_a = torch.full((n,), prev, dtype=torch.int32)
    cur_a = torch.full((n,), cur, dtype=torch.int32)
    if mode == "exact":
        nbrs, nwts = padded_neighbors(small)
        nxt = tn2v._second_order_step_exact(small, es, nbrs, nwts, prev_a, cur_a, 7, 1 / p, 1 / q)
    else:
        nxt = tn2v._second_order_step_rejection(small, None, es, prev_a, cur_a, 7, 1 / p,
                                                1 / q, 24, False)
    nxt = nxt.numpy()
    assert (nxt >= 0).all()
    emp = np.bincount(nxt, minlength=small.n_nodes) / n
    want = tn2v.node2vec_transition_probs(small, prev, cur, p, q)
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv < 0.06, f"total variation {tv} for mode={mode}, p={p}, q={q}"


@pytest.mark.parametrize("mode", ["rejection", "exact"])
def test_node2vec_walks_edges_valid(small, weighted_pair, mode):
    for g in (small, weighted_pair[1]):
        starts = torch.arange(g.n_nodes, dtype=torch.int32)
        walks = tn2v.node2vec_walks(g, starts, 8, p=0.25, q=0.25, key=0, mode=mode,
                                    weighted=g.is_weighted, device=CPU)
        assert walks.shape == (g.n_nodes, 9)
        _assert_valid(g, walks)


def test_simulate_walks_reference_budget(karate_port):
    """num_walks passes of walk_length nodes (node2vec/src/main.py:35-41)."""
    walks = simulate_walks(karate_port, num_walks=2, walk_length=10, key=0, device=CPU)
    n_active = int((karate_port.host[3] > 0).sum())
    assert n_active == 34
    assert walks.shape == (2 * n_active, 10)
    corpus = walks_to_corpus(walks)
    assert all(len(c) == 10 for c in corpus)  # karate has no dead ends
    assert sorted(walks[:, 0].tolist()) == sorted(list(range(1, 35)) * 2)


def test_alias_method_statistics():
    probs = [0.1, 0.2, 0.3, 0.4]
    j, q = alias_setup(probs)
    draws = alias_sample(j, q, np.random.default_rng(0), 20000)
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / 20000, probs, atol=0.02)


def test_directed_walks_follow_out_edges():
    dg = build_graph(np.array([[0, 1], [1, 2], [2, 0], [2, 3]]), n_nodes=4, directed=True)
    walks = uniform_walks(dg.out, torch.zeros(50, dtype=torch.int32), 5, 0, device=CPU)
    _assert_valid(dg.out, walks)
    w = walks.numpy()
    for row in w:  # node 3 is a sink: walks reaching it stop
        hit = np.where(row == 3)[0]
        if len(hit) and hit[0] < 5:
            assert (row[hit[0] + 1:] == -1).all()
    assert (w == 3).any()


def test_walks_deterministic_given_key(small):
    a = simulate_walks(small, 2, 12, 9, p=0.5, q=2.0, device=CPU)
    b = simulate_walks(small, 2, 12, 9, p=0.5, q=2.0, device=CPU)
    assert torch.equal(a, b)
    c = simulate_walks(small, 2, 12, 10, p=0.5, q=2.0, device=CPU)
    assert (a != c).any()


def test_uniform_walks_sort_gather_valid_and_statistical(small):
    w = uniform_walks(small, torch.arange(64, dtype=torch.int32), 8, 3, sort_gather=True,
                      device=CPU)
    _assert_valid(small, w)
    w2 = uniform_walks(small, torch.zeros(2000, dtype=torch.int32), 1, 5, sort_gather=True,
                       device=CPU).numpy()
    rp, col, _, _ = small.host
    nbrs = np.unique(col[rp[0]: rp[1]])
    counts = np.array([(w2[:, 1] == n).sum() for n in nbrs])
    expected = 2000 / len(nbrs)
    assert counts.sum() == 2000
    assert np.all(np.abs(counts - expected) < 6 * np.sqrt(expected) + 10)


def test_uniform_walks_sort_gather_weighted(weighted_pair):
    g = weighted_pair[1]
    w = uniform_walks(g, torch.arange(32, dtype=torch.int32), 5, 1, weighted=True,
                      sort_gather=True, device=CPU)
    _assert_valid(g, w)


def test_node2vec_walks_sort_gather_valid(small):
    w = tn2v.node2vec_walks(small, torch.arange(48, dtype=torch.int32), 6, p=0.5, q=2.0,
                            key=9, sort_gather=True, device=CPU)
    _assert_valid(small, w)


def test_walk_entry_points_raise_without_card(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    starts = torch.arange(4, dtype=torch.int32)
    for call in (lambda: simulate_walks(small, 1, 5, 0),
                 lambda: simulate_walks(small, 1, 5, 0, p=1.0, q=2.0),
                 lambda: uniform_walks(small, starts, 3, 0),
                 lambda: tn2v.node2vec_walks(small, starts, 3, 1.0, 2.0, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
