"""graphtpu_torch's support modules against graphtpu's: BFS distances, the
weight statistics, the dataset registry, the sqlite store and the feature
emitters, the ``.csr.npz`` sidecar read across packages, the C++ edge-list
parser against both numpy readers, the generators, and the package's
independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphtpu
from graphtpu.bench import generators as jgen
from graphtpu.core import registry as jreg
from graphtpu.core import stats as jstats
from graphtpu.core.traversal import bfs_distances as j_bfs
from graphtpu.eval import features as jfeat
from graphtpu.io import db as jdb
from graphtpu.io.edgelist import read_edgelist as j_read_edgelist
import graphtpu_torch as gt
from graphtpu_torch.bench import generators as tgen
from graphtpu_torch.core import registry as treg
from graphtpu_torch.core import stats as tstats
from graphtpu_torch.core.traversal import bfs_distances as t_bfs
from graphtpu_torch.eval import features as tfeat
from graphtpu_torch.io import db as tdb
from graphtpu_torch.io.edgelist import read_edgelist, read_edgelist_numpy
from graphtpu_torch.native import generate_graph, parse_edgelist

torch.set_num_threads(1)
STATS_RTOL = 1e-6  # float32 row sums against float64, of the largest entry
# graphtpu's one-pass variance, E[w^2] - E[w]^2 in float32, cancels (ROADMAP C6)
GRAPHTPU_VAR_RTOL = 1e-5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edges(v=60, e=150, seed=0, pieces=True):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v // 2 if pieces else v, (e, 2))
    if pieces:  # a second component and isolated nodes
        edges = np.concatenate([edges, rng.integers(v // 2, v - 5, (e // 3, 2))])
    return edges[edges[:, 0] != edges[:, 1]]


@pytest.mark.parametrize("chunk,max_dist", [(32, 127), (7, 127), (16, 2)])
def test_bfs_distances_equal_graphtpu(chunk, max_dist):
    v = 60
    edges = _edges(v)
    src = np.array([0, 3, 31, 40, 59, 12, 7, 33, 50, 1], np.int32)
    got = t_bfs(gt.build_graph(edges, n_nodes=v), src, max_dist=max_dist, source_chunk=chunk,
                device="cpu")
    want = j_bfs(graphtpu.build_graph(edges, n_nodes=v), src, max_dist=max_dist,
                 source_chunk=chunk)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got > 1).any()
    default = t_bfs(gt.build_graph(edges, n_nodes=v), device="cpu")
    np.testing.assert_array_equal(default, j_bfs(graphtpu.build_graph(edges, n_nodes=v)))


@pytest.mark.parametrize("weighted", [False, True])
def test_weight_stats_match(weighted):
    v = 41
    edges = _edges(v, 200, seed=1)
    wts = np.random.default_rng(2).uniform(0.1, 1.1, len(edges)).astype(np.float32) \
        if weighted else None
    tg = gt.build_graph(edges, wts, n_nodes=v)
    jg = graphtpu.build_graph(edges, wts, n_nodes=v)
    for tf, jf, tol in ((tstats.out_weight_sums, jstats.out_weight_sums, STATS_RTOL),
                        (tstats.out_weight_variance, jstats.out_weight_variance,
                         GRAPHTPU_VAR_RTOL)):
        got, want = tf(tg).numpy(), np.asarray(jf(jg))
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
        np.testing.assert_array_equal(got, tf(tg).numpy())  # the same bits run to run
    u = np.array([0, 5, 40, 3], np.int32)
    w = np.array([1, 2, 39, 3], np.int32)
    np.testing.assert_array_equal(tstats.evidence(tg, torch.from_numpy(u), torch.from_numpy(w)).numpy(),
                                  np.asarray(jstats.evidence(jg, u, w)))


def test_weight_stats_against_float64():
    rng = np.random.default_rng(3)
    v = 30
    edges = _edges(v, 120, seed=3, pieces=False)
    wts = rng.uniform(0.1, 1.1, len(edges)).astype(np.float32)
    g = gt.build_graph(edges, wts, n_nodes=v)
    rp, col, w, deg = g.host
    sums = np.array([w[rp[i]:rp[i + 1]].astype(np.float64).sum() for i in range(v)])
    var = np.array([w[rp[i]:rp[i + 1]].astype(np.float64).var() if deg[i] else 0.0
                    for i in range(v)])
    for got, want in ((tstats.out_weight_sums(g), sums), (tstats.out_weight_variance(g), var)):
        assert np.abs(got.numpy() - want).max() <= STATS_RTOL * want.max()


def test_registry_names_equal_graphtpu(tmp_path, monkeypatch):
    assert treg.names() == jreg.names()
    # with reference files present, both register the same entries
    for rel in ("DeepSim/lshrank_data/realdata/blog.txt", "node2vec/graph/karate.edgelist",
                "node2vec/src/blogcatalog.mat"):
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        (tmp_path / rel).write_text("1 2\n2 3\n")
    monkeypatch.setenv("GRAPHTPU_REFERENCE_DATA", str(tmp_path))
    monkeypatch.setattr(treg, "_REGISTRY", {})
    monkeypatch.setattr(jreg, "_REGISTRY", {})
    treg._maybe_register_reference_data()
    jreg._maybe_register_reference_data()
    assert treg.names() == jreg.names() == ["blog", "karate"]
    for name in treg.names():
        t, j = treg.get(name), jreg.get(name)
        assert (t.n_nodes, t.path, t.labels_path) == (j.n_nodes, j.path, j.labels_path)
    g = treg.load_graph("karate")
    assert g.n_nodes == 35 and g.n_edges == 4
    treg.register(treg.DatasetSpec(name="gen", n_nodes=5,
                                   generator=lambda: (np.array([[0, 1], [3, 4]]), None)))
    assert treg.load_graph("gen").n_edges == 4


def test_graph_store_and_feature_emitters_match(tmp_path):
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 20, (30, 2))
    wts = rng.random(30).astype(np.float32)
    idx = rng.integers(-1, 20, (6, 5))
    vals = rng.random((6, 5))
    rows = {}
    for name, mod in (("t", tdb), ("j", jdb)):
        store = mod.GraphStore(str(tmp_path / f"{name}.db"))
        store.insert_edges(edges, wts)
        store.insert_edges(edges[:3])
        store.insert_topk(idx, vals, "uniwalk")
        store.insert_topk(idx[:2], vals[:2], "topsim", sources=np.array([7, 9]))
        rows[name] = (store.query_edges(), [store.query_topk(s, 3, a) for s in range(10)
                                            for a in (None, "uniwalk", "topsim")])
        store.close()
    (te, tw), tq = rows["t"]
    (je, jw), jq = rows["j"]
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tw, jw)
    assert tq == jq

    walks = rng.integers(-1, 9, (8, 6))
    walks[2] = -1
    a, b = str(tmp_path / "tp.txt"), str(tmp_path / "jp.txt")
    assert tfeat.produce_paths(walks, a) == jfeat.produce_paths(walks, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    gold = {s: [(int(d), 1.0) for d in rng.choice(12, 6, replace=False)] for s in range(5)}
    single = {s: [(int(d), 1.0) for d in rng.choice(12, 6, replace=False)] for s in range(5)}
    double = {s: [(int(d), 1.0) for d in rng.choice(12, 6, replace=False)] for s in range(4)}
    assert tfeat.produce_labels(single, double, gold, 4) == jfeat.produce_labels(single, double,
                                                                                 gold, 4)
    scores = {"a": 0.2, "b": 0.7, "c": 0.7}
    assert tfeat.max_precision(scores) == jfeat.max_precision(scores)


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_sidecar_loads_in_either_package(tmp_path, weighted):
    rng = np.random.default_rng(6)
    edges = _edges(50, 120, seed=6)
    lines = [f"{a} {b}" + (f" {w:.3f}" if weighted else "") for (a, b), w in
             zip(edges, rng.random(len(edges)))]
    for writer in ("t", "j"):
        path = str(tmp_path / f"{writer}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        first = (gt.load_graph_cached if writer == "t" else graphtpu.load_graph_cached)(
            path, n_nodes=50, weighted=weighted)
        assert os.path.exists(path + ".csr.npz")
        tg = gt.load_graph_cached(path, n_nodes=50, weighted=weighted)
        jg = graphtpu.load_graph_cached(path, n_nodes=50, weighted=weighted)
        first_host = first.host if writer == "t" else graphtpu.core.graph.host_csr(first)
        for a, b, c in zip(tg.host, graphtpu.core.graph.host_csr(jg), first_host):
            if c is None:
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
                np.testing.assert_array_equal(a, np.asarray(c))
        assert tg.max_degree == jg.max_degree and (tg.weight is not None) == weighted


FORMATS = {
    "space": "0 1\n1 2\n2 5\n",
    "tab": "0\t1\n1\t2\n7\t3\n",
    "comma": "0,1\n1,2\n4,6\n",
    "weighted": "0 1 0.5\n1 2 2.25\n3 0 1e-3\n",
    "weighted_comma": "0,1,0.5\n1,2,2.25\n",
    "blank_lines": "0 1\n\n1 2\n   \n2 3\n\n",
    "crlf": "0 1\r\n1 2\r\n2 4\r\n",
    "crlf_weighted": "0 1 0.5\r\n1 2 0.25\r\n",
    "comments": "# src dst\n0 1\n# more\n1 2\n",
    "no_final_newline": "0 1\n5 6",
    "negative_and_wide": "12345678901 -3\n-3 4\n",
}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_cpp_parser_equals_both_numpy_readers(tmp_path, name):
    path = str(tmp_path / f"{name}.txt")
    with open(path, "w", newline="") as f:
        f.write(FORMATS[name])
    got = read_edgelist(path)
    for want in (read_edgelist_numpy(path), j_read_edgelist(path)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype == np.int64
        if want[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("delimiter", [",", "\t"])
def test_cpp_parser_with_a_given_delimiter(tmp_path, delimiter):
    path = str(tmp_path / "d.txt")
    edges = _edges(30, 40, seed=7)
    gt.io.edgelist.write_edgelist(path, edges, delimiter=delimiter)
    np.testing.assert_array_equal(parse_edgelist(path, delimiter)[0], edges)
    np.testing.assert_array_equal(read_edgelist_numpy(path, delimiter)[0], edges)
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    assert parse_edgelist(empty)[0].shape == (0, 2)
    with pytest.raises(FileNotFoundError):
        parse_edgelist(str(tmp_path / "missing.txt"))


def test_leading_blank_line_is_read_only_by_the_cpp_parser(tmp_path):
    """ROADMAP C5: the numpy readers take a blank first line for an empty
    file; the C++ parser reads the edges after it."""
    path = str(tmp_path / "b.txt")
    with open(path, "w") as f:
        f.write("\n0 1\n1 2\n")
    np.testing.assert_array_equal(read_edgelist(path)[0], [[0, 1], [1, 2]])
    assert read_edgelist_numpy(path)[0].shape == (0, 2)
    assert j_read_edgelist(path)[0].shape == (0, 2)


def test_generators_equal_graphtpu(tmp_path):
    np.testing.assert_array_equal(tgen.directed_random_graph(200, 6, seed=4),
                                  jgen.directed_random_graph(200, 6, seed=4))
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    n = tgen.massive_bipartite_graph(300, 200, 6, a, seed=5, chunk=700, use_native=False)
    assert n == jgen.massive_bipartite_graph(300, 200, 6, b, seed=5, chunk=700, use_native=False)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert n == (300 + 200) * 6 // 2


@pytest.mark.parametrize("mode,n_left,n_right", [("bipartite", 3000, 2000), ("uniform", 5000, 0),
                                                 ("directed", 4000, 0)])
def test_cpp_generator_writes_distinct_in_range_edges(tmp_path, mode, n_left, n_right):
    path = str(tmp_path / f"{mode}.txt")
    target = 150_000  # past 100,000 edges the generator runs one thread per core
    assert generate_graph(path, mode, n_left, n_right, target, seed=3) == target
    edges, wts = parse_edgelist(path)
    assert wts is None and edges.shape == (target, 2)
    a, b = edges[:, 0], edges[:, 1]
    if mode == "bipartite":
        assert a.min() >= 0 and a.max() < n_left
        assert b.min() >= n_left and b.max() < n_left + n_right
    else:
        assert edges.min() >= 0 and edges.max() < n_left and (a != b).all()
    key = np.minimum(a, b) * (n_left + n_right) + np.maximum(a, b) if mode == "uniform" \
        else a * (n_left + n_right) + b
    assert len(np.unique(key)) == target
    with pytest.raises(ValueError, match="key space"):
        generate_graph(path, mode, 10, 10, 10_000)
    with pytest.raises(ValueError, match="mode"):
        generate_graph(path, "ring", 10)


def test_massive_native_writes_its_target(tmp_path):
    path = str(tmp_path / "m.txt")
    n = tgen.massive_bipartite_graph(400, 300, 4, path, seed=1)
    edges, _ = read_edgelist(path)
    assert n == len(edges) == 1400 and edges[:, 1].min() >= 400


def test_new_modules_import_neither_jax_nor_graphtpu():
    code = (
        "import sys\n"
        "import graphtpu_torch, graphtpu_torch.cli, graphtpu_torch.pipelines_deepsim\n"
        "import graphtpu_torch.models.deepsim, graphtpu_torch.models.sdne\n"
        "import graphtpu_torch.models.lapeigen, graphtpu_torch.viz, graphtpu_torch.native\n"
        "import graphtpu_torch.core.stats, graphtpu_torch.core.traversal\n"
        "import graphtpu_torch.core.registry, graphtpu_torch.core.convert\n"
        "import graphtpu_torch.io.db, graphtpu_torch.eval.features\n"
        "import graphtpu_torch.bench.generators\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'graphtpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
