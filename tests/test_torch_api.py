"""graphtpu_torch's public API against graphtpu's: the host-side Graph and
DiGraph members, ``bfs_order(start=)`` and ``locality_score(window=)``
bit-equal on the same graphs, and the package-level re-exports."""

import importlib
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.core import graph as jgraph
from graphtpu.core import reorder as jreorder
from graphtpu_torch.core import graph as tgraph
from graphtpu_torch.core import reorder as treorder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_core_io.py's graphs, by (edges, build_graph keywords)
_IO_GRAPHS = {
    "path": ([[0, 1], [1, 2]], {}),
    "multi_dedup": ([[0, 2], [0, 1], [0, 2]], {}),
    "multi_keep": ([[0, 2], [0, 1], [0, 2]], {"dedup": False}),
    "directed": ([[0, 1], [2, 1]], {"directed": True}),
}


def slot_edges(jg):
    """Every directed CSR slot of a graphtpu graph as an [E, 2] edge array."""
    rp, col, _, _ = jgraph.host_csr(jg)
    src = np.repeat(np.arange(jg.n_nodes), np.diff(np.asarray(rp)))
    return np.stack([src, np.asarray(col)], 1)


def ring_of_cliques(n_cliques=16, k=8, seed=3):
    """tests/test_reorder.py's shuffled ring of k-cliques, as an edge array."""
    edges = []
    for c in range(n_cliques):
        base = c * k
        edges += [(base + i, base + j) for i in range(k) for j in range(i + 1, k)]
        edges.append((base, ((c + 1) % n_cliques) * k))
    return np.random.default_rng(seed).permutation(n_cliques * k)[np.asarray(edges)]


def both_graphs(name, request, extra_nodes=0):
    """(graphtpu graph, port graph) from the same edges."""
    if name == "ring_of_cliques":
        edges, v = ring_of_cliques(), 128
    else:
        jg = request.getfixturevalue(name)
        edges, v = slot_edges(jg), jg.n_nodes
    v += extra_nodes
    return graphtpu.build_graph(edges, n_nodes=v), gt.build_graph(edges, n_nodes=v)


def assert_same_rows(tg, jg):
    """neighbors(v) equal in value and dtype, degree(v) equal, at every node."""
    assert tg.n_nodes == jg.n_nodes
    for v in range(jg.n_nodes):
        got, want = tg.neighbors(v), jg.neighbors(v)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (v, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"node {v}")
        d = tg.degree(v)
        assert type(d) is int and d == jg.degree(v), v
    if tg.n_edges:
        v = int(np.argmax(tg.host[3]))
        tg.neighbors(v)[:] = -1
        assert (tg.host[1][tg.host[0][v]: tg.host[0][v + 1]] >= 0).all()


@pytest.mark.parametrize("name", [*_IO_GRAPHS, "small_random"])
def test_neighbors_and_degree_match(name, request):
    if name == "small_random":
        jg, tg = both_graphs(name, request)
    else:
        edges, kw = _IO_GRAPHS[name]
        jg = graphtpu.build_graph(np.array(edges), n_nodes=3, **kw)
        tg = gt.build_graph(np.array(edges), n_nodes=3, **kw)
    pairs = [(tg.out, jg.out), (tg.in_, jg.in_)] if name == "directed" else [(tg, jg)]
    for t, j in pairs:
        assert_same_rows(t, j)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_digraph_sizes_match(dedup, weighted):
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 40, size=(300, 2))
    edges = np.concatenate([edges, edges[:50]])
    wts = rng.random(len(edges)).astype(np.float32) if weighted else None
    kw = dict(n_nodes=45, directed=True, dedup=dedup)
    jg = graphtpu.build_graph(edges, wts, **kw)
    tg = gt.build_graph(edges, wts, **kw)
    assert (tg.n_nodes, tg.n_edges) == (jg.n_nodes, jg.n_edges)
    assert (tg.n_nodes, tg.n_edges) == (tg.out.n_nodes, tg.out.n_edges)
    assert type(tg.n_nodes) is int and type(tg.n_edges) is int


def _start(which, g):
    deg = g.host[3]
    return {"zero": 0, "hub": int(np.argmax(deg)), "middle": g.n_nodes // 2,
            "isolated": g.n_nodes - 1}[which]


@pytest.mark.parametrize("which", ["zero", "hub", "middle", "isolated"])
@pytest.mark.parametrize("name", ["small_random", "ring_of_cliques"])
def test_bfs_order_start_matches(name, which, request):
    # the isolated start is one extra node that no edge touches
    jg, tg = both_graphs(name, request, extra_nodes=int(which == "isolated"))
    s = _start(which, tg)
    got = treorder.bfs_order(tg, start=s)
    want = np.asarray(jreorder.bfs_order(jg, start=s))
    assert got.dtype == np.int32 and got[0] == s
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(tg.n_nodes))
    if which == "isolated":
        assert tg.degree(s) == 0


@pytest.mark.parametrize("window", [0, 1, 2, 5])
@pytest.mark.parametrize("name", ["small_random", "ring_of_cliques"])
def test_locality_score_window_matches(name, window, request):
    jg, tg = both_graphs(name, request)
    assert treorder.locality_score(tg, window=window) == jreorder.locality_score(jg, window=window)
    order = treorder.bfs_order(tg)
    tg2, _ = treorder.relabel_graph(tg, order)
    jg2, _ = jreorder.relabel_graph(jg, order)
    after = treorder.locality_score(tg2, window=window)
    assert after == jreorder.locality_score(jg2, window=window)
    assert treorder.locality_score(tg2) == treorder.locality_score(tg2, window=1)


def test_graph_members_and_core_signatures_cover_graphtpu():
    """No public Graph/DiGraph member, and no parameter of a function in
    core.graph or core.reorder, that graphtpu has and the port lacks; a
    plain default (a number, string or None) is the same."""
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    for name in ("Graph", "DiGraph"):
        missing = public(getattr(jgraph, name)) - public(getattr(tgraph, name))
        assert not missing, (name, missing)
    for jmod, tmod in ((jgraph, tgraph), (jreorder, treorder)):
        for name, fn in vars(jmod).items():
            if name.startswith("_") or not inspect.isfunction(fn) or fn.__module__ != jmod.__name__:
                continue
            want = inspect.signature(fn).parameters
            got = inspect.signature(getattr(tmod, name)).parameters
            for p in want:
                assert p in got, (tmod.__name__, name, p)
                if want[p].default is None or type(want[p].default) in (bool, int, float, str):
                    assert got[p].default == want[p].default, (name, p)


_PACKAGES = ["core", "io", "kernels", "models", "eval", "bench"]


@pytest.mark.parametrize("pkg", _PACKAGES)
def test_package_all_equals_graphtpu(pkg):
    t = importlib.import_module(f"graphtpu_torch.{pkg}")
    j = importlib.import_module(f"graphtpu.{pkg}")
    assert set(t.__all__) == set(j.__all__)
    assert len(t.__all__) == len(set(t.__all__))


@pytest.mark.parametrize("pkg", _PACKAGES)
def test_package_names_are_the_port_modules_own(pkg):
    """Each re-export is the object of the port module that sits opposite
    the graphtpu module defining the name."""
    t = importlib.import_module(f"graphtpu_torch.{pkg}")
    j = importlib.import_module(f"graphtpu.{pkg}")
    for name in j.__all__:
        jobj = getattr(j, name)
        home = jobj.__name__ if isinstance(jobj, types.ModuleType) else jobj.__module__
        port_home = importlib.import_module("graphtpu_torch" + home[len("graphtpu"):])
        want = port_home if isinstance(jobj, types.ModuleType) else getattr(port_home, name)
        assert getattr(t, name) is want, (pkg, name)


@pytest.mark.parametrize("pkg", ["", ".simrank", ".walks", ".utils", ".dist"])
def test_other_packages_cover_graphtpu(pkg):
    t = importlib.import_module(f"graphtpu_torch{pkg}")
    j = importlib.import_module(f"graphtpu{pkg}")
    assert set(j.__all__) <= set(t.__all__), set(j.__all__) - set(t.__all__)
    for name in t.__all__:
        assert hasattr(t, name), name


def test_packages_import_no_jax_graphtpu_or_kernel_build():
    pkgs = ["graphtpu_torch"] + [f"graphtpu_torch.{p}" for p in (
        *_PACKAGES, "simrank", "walks", "utils", "dist")]
    assert len(pkgs) == 11
    code = (
        "import importlib, sys\n"
        f"for p in {pkgs!r}:\n"
        "    importlib.import_module(p)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'graphtpu')\n"
        "       or m == 'graphtpu_torch.kernels._build']\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
