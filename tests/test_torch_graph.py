"""graphtpu_torch core: CSR construction, padding, dense operators and
relabeling against graphtpu on the same inputs."""

import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.core import graph as jgraph
from graphtpu.core import reorder as jreorder
from graphtpu.io.edgelist import read_edgelist as j_read_edgelist
from graphtpu_torch.core import graph as tgraph
from graphtpu_torch.core import reorder as treorder
from graphtpu_torch.core.convert import graph_from_numpy
from graphtpu_torch.io.edgelist import read_edgelist, write_edgelist

torch.set_num_threads(1)


def assert_same_csr(tg, jg):
    """Exact equality of the host mirror and tensors with graphtpu's host_csr."""
    want = jgraph.host_csr(jg)
    got = tgraph.host_csr(tg)
    for name, a, b in zip(("row_ptr", "col", "weight", "deg"), got, want):
        if b is None:
            assert a is None, name
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tg.row_ptr.numpy(), np.asarray(jg.row_ptr))
    np.testing.assert_array_equal(tg.col.numpy(), np.asarray(jg.col))
    np.testing.assert_array_equal(tg.deg.numpy(), np.asarray(jg.deg))
    assert tg.max_degree == jg.max_degree
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges


def slot_edges(jg):
    """Every directed CSR slot of a graphtpu graph as an [E, 2] edge array."""
    rp, col, _, _ = jgraph.host_csr(jg)
    src = np.repeat(np.arange(jg.n_nodes), np.diff(np.asarray(rp)))
    return np.stack([src, np.asarray(col)], 1)


@pytest.mark.parametrize("fixture", ["ring16", "small_random", "karate"])
def test_build_graph_matches_graphtpu(fixture, request):
    jg = request.getfixturevalue(fixture)
    edges = slot_edges(jg)
    tg = gt.build_graph(edges, n_nodes=jg.n_nodes)
    assert_same_csr(tg, graphtpu.build_graph(edges, n_nodes=jg.n_nodes))
    assert_same_csr(tg, jg)


def test_weighted_duplicates_keep_last_weight():
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 30, size=(200, 2))
    edges = np.concatenate([edges, edges[:40]])  # duplicates, new weights
    wts = rng.random(len(edges)).astype(np.float32) + 0.1
    for dedup in (True, False):
        tg = gt.build_graph(edges, wts, n_nodes=32, dedup=dedup)
        jg = graphtpu.build_graph(edges, wts, n_nodes=32, dedup=dedup)
        assert_same_csr(tg, jg)


def test_digraph_out_and_in_csr():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 24, size=(90, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    wts = rng.random(len(edges)).astype(np.float32)
    for w in (None, wts):
        tg = gt.build_graph(edges, w, n_nodes=24, directed=True)
        jg = graphtpu.build_graph(edges, w, n_nodes=24, directed=True)
        assert isinstance(tg, gt.DiGraph)
        assert_same_csr(tg.out, jg.out)
        assert_same_csr(tg.in_, jg.in_)


def test_pad_graph_nodes_matches(small_random):
    tg = gt.build_graph(slot_edges(small_random), n_nodes=64)
    assert_same_csr(
        tgraph.pad_graph_nodes(tg, 100), jgraph.pad_graph_nodes(small_random, 100)
    )
    assert tgraph.pad_graph_nodes(tg, 64) is tg


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_adjacency_and_row_normalized(weighted):
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 40, size=(150, 2))
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    tg = gt.build_graph(edges, wts, n_nodes=42)  # two isolated nodes
    jg = graphtpu.build_graph(edges, wts, n_nodes=42)
    a_t = tgraph.dense_adjacency(tg)
    a_j = np.asarray(jgraph.dense_adjacency(jg))
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    p_t = tgraph.row_normalized(a_t).numpy()
    p_j = np.asarray(jgraph.row_normalized(jgraph.dense_adjacency(jg)))
    # row sums of float weights may be added in another order
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=0)
    assert (p_t[40:] == 0).all()


@pytest.mark.parametrize("name", ["bfs_order", "rcm_order", "degree_order"])
def test_orders_match(small_random, name):
    tg = gt.build_graph(slot_edges(small_random), n_nodes=64)
    got = getattr(treorder, name)(tg)
    want = np.asarray(getattr(jreorder, name)(small_random))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_relabel_graph_and_locality_match():
    rng = np.random.default_rng(11)
    v = 200
    base = np.stack([np.arange(v - 1), np.arange(1, v)], 1)
    perm = rng.permutation(v)
    edges = perm[np.concatenate([base, base[:-1] + [0, 1]])]
    wts = rng.random(len(edges)).astype(np.float32)
    tg = gt.build_graph(edges, wts, n_nodes=v)
    jg = graphtpu.build_graph(edges, wts, n_nodes=v)
    order = treorder.bfs_order(tg)
    tg2, tinv = treorder.relabel_graph(tg, order)
    jg2, jinv = jreorder.relabel_graph(jg, order)
    assert_same_csr(tg2, jg2)
    np.testing.assert_array_equal(tinv, np.asarray(jinv))
    assert treorder.locality_score(tg2) == jreorder.locality_score(jg2)
    assert treorder.locality_score(tg2) > treorder.locality_score(tg)


def test_graph_from_numpy_round_trips(small_random):
    arrays = jgraph.host_csr(small_random)
    tg = graph_from_numpy(*(None if a is None else np.asarray(a) for a in arrays))
    assert_same_csr(tg, small_random)
    again = graph_from_numpy(*tgraph.host_csr(tg))
    assert_same_csr(again, small_random)
    assert again.to("cpu").host is again.host


@pytest.mark.parametrize("delimiter", [" ", ",", "\t"])
def test_edgelist_read_matches_graphtpu(tmp_path, delimiter):
    rng = np.random.default_rng(2)
    edges = rng.integers(0, 50, size=(120, 2))
    wts = (rng.random(120) * 4).astype(np.float32)
    path = str(tmp_path / "g.txt")
    write_edgelist(path, edges, wts, delimiter=delimiter)
    got_e, got_w = read_edgelist(path)
    want_e, want_w = j_read_edgelist(path)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_w, want_w)
    tg = gt.read_edgelist_graph(path, weighted=True, n_nodes=52)
    jg = graphtpu.read_edgelist_graph(path, weighted=True, n_nodes=52)
    assert_same_csr(tg, jg)


@pytest.mark.parametrize(
    "name,args",
    [("uniform_random_graph", (300, 8, 3)),
     ("bipartite_random_graph", (40, 60, 5, 4)),
     ("rmat_graph", (10, 5000))],
)
def test_generators_match_graphtpu(name, args):
    from graphtpu.bench import generators as jgen
    from graphtpu_torch.bench import generators as tgen

    np.testing.assert_array_equal(getattr(tgen, name)(*args), getattr(jgen, name)(*args))
