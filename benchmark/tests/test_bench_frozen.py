"""The yardstick: the frozen generators and roofline arithmetic against the
program's and hand counts, and what the benchmark's modules import."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest

from benchmark import roofline
from benchmark.gen import graphs
from benchmark.reference import simrank as reference
from benchmark.tests.conftest import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_equal_the_programs(seed):
    from graphtpu_torch.bench import generators

    np.testing.assert_array_equal(graphs.uniform_pairs(seed, 10240, 330_000),
                                  generators.blog_shaped_edges(seed))
    np.testing.assert_array_equal(graphs.rmat(seed, 14, 330_000), generators.rmat14_edges(seed))


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_urand_is_gaps_uniform_graph(seed):
    e = graphs.edges_of(_config("urand-simrank")["graph"], seed)
    draws = graphs.uniform_pairs(seed, 1 << 15, 16 << 15)
    np.testing.assert_array_equal(e, draws[draws[:, 0] != draws[:, 1]])
    assert (16 << 15) - 100 < len(e) < 16 << 15  # about 16 self-loops a seed
    assert e.min() >= 0 and e.max() < 1 << 15


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_kron_is_graph500s_draws_relabelled(seed):
    from graphtpu_torch.bench import generators

    cfg = _config("kron-simrank")["graph"]
    e = graphs.edges_of(cfg, seed)
    draws = generators.rmat_graph(15, 16 << 15, tuple(cfg["initiator"]), seed=seed)
    assert e.shape == draws.shape
    perm = np.full(1 << 15, -1)
    perm[draws.ravel()] = e.ravel()  # one label per vertex: a relabelling
    assert (np.bincount(perm[perm >= 0], minlength=1 << 15) <= 1).all()
    np.testing.assert_array_equal(perm[draws], e)
    assert not np.array_equal(e, draws)


def test_reference_p_matches_the_programs_graph():
    from graphtpu_torch.core.graph import build_graph

    cfg = _config("kron-simrank")["graph"]
    edges = graphs.edges_of(cfg, 0)
    g = build_graph(edges, n_nodes=cfg["n_nodes"])
    assert reference.nnz(edges, cfg["n_nodes"]) == g.n_edges


def test_roofline_hand_counts_at_blog():
    v, nnz = 10_496, 657_924
    # B1 pinned: 6 operations a nonzero and column (pin, multiply, Kahan 4)
    pinned = roofline.bound_ms(*roofline.spmv_work(nnz, v, v, 4, kahan=True, pin=True))
    unpinned = roofline.bound_ms(*roofline.spmv_work(nnz, v, v, 4, kahan=True, pin=False))
    # (the program's stream counts 256 more items, its pad rows' dummies: 0.619)
    assert pinned == pytest.approx(6 * nnz * v / 67e12 * 1e3)
    assert pinned == pytest.approx(0.6184, abs=1e-4)
    assert unpinned == pytest.approx(0.5154, abs=1e-4)
    assert roofline.iteration_ms(nnz, v) == pytest.approx(0.4123, abs=1e-4)
    # 30 iterations: 31 unpinned products, 29 pinned
    assert roofline.products_ms(nnz, v, 30, 4, True) == pytest.approx(31 * unpinned + 29 * pinned)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_and_a_reference_apart_from_the_program():
    files = [p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & {"jax", "jaxlib", "flax", "graphtpu"}, p
        if "reference" in p.parts:
            assert not tops & {"graphtpu_torch", "benchmark"}, p
