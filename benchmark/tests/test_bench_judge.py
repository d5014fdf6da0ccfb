"""A runner that judges its own answers: a cell that is not SimRank (a
degree count of the Kronecker graph, judged against a numpy reference),
added from new files and entries alone, reads correct without the
harness's SimRank reference, and its faults read as not correct."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import check, harness
from benchmark.reference import simrank as simrank_reference

CPU = torch.device("cpu")
CELL = "kron.degree-count"

RUNNER = '''"""A degree count: one unit builds the program's graph from the edges;
judged against the distinct neighbours of each node, counted in numpy."""

import numpy as np

from graphtpu_torch.core import graph


def reference_degrees(edges, n_nodes):
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    key = np.unique(np.concatenate([e[:, 0] * n_nodes + e[:, 1], e[:, 1] * n_nodes + e[:, 0]]))
    return np.bincount(key // n_nodes, minlength=n_nodes)


def setup(ctx):
    mode = ctx.mode or ctx.config["mode"]  # the caller's (a control's), else the configuration's
    if mode != ctx.config["mode"]:
        raise SystemExit(f"the degree count runs mode {ctx.config['mode']}, not {mode!r}")
    return {"edges": ctx.edges, "n_nodes": ctx.n_nodes, "device": ctx.device}


def unit(state, rec):
    g = graph.build_graph(state["edges"], n_nodes=state["n_nodes"], device=state["device"])
    return g.deg.cpu().numpy(), g.n_edges


def judge(state, kept):
    want = reference_degrees(state["edges"], state["n_nodes"])
    return [{"degree_off": float((deg != want).sum()),
             "edges_off": float(abs(n_edges - int(want.sum())))} for deg, n_edges in kept]


def release(state):
    state.clear()
'''


@pytest.fixture
def degree_cell(tiny):
    """The tiny copy with the degree-count cell added as new files and
    entries, and the bytes of every file that was there before."""
    b = tiny / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    (b / "configs" / "kron-degree.json").write_text(json.dumps({
        "graph": {"generator": "kron", "scale": 8, "edge_factor": 16,
                  "initiator": [0.57, 0.19, 0.19, 0.05], "n_nodes": 256},
        "mode": "exact",
        "semantics": "undirected graph, each pair mirrored and duplicates collapsed; "
                     "the degree of a node is its number of distinct neighbours"}))
    (b / "traffic" / "degree-count.json").write_text(json.dumps({
        "runner": "degree_count", "trace_units": 1,
        "spans": {"build": {"call": "graphtpu_torch.core.graph:build_graph"}}}))
    (b / "runners" / "degree_count.py").write_text(RUNNER)
    (b / "metrics" / "build_s.degree.py").write_text(
        "def read(rec):\n    return rec['window_s'] / rec['units'] if rec['units'] else None\n")
    (b / "metrics" / "build_ms.degree.py").write_text(
        "from statistics import median\n\n\ndef read(rec):\n"
        "    xs = rec['spans'].get('build', [])\n    return median(xs) if xs else None\n")
    (b / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": {"degree_off": 0, "edges_off": 0}}))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kron-degree", "source": "test",
                             "file": "benchmark/configs/kron-degree.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "kron-degree",
                               "traffic": "degree-count", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "build_s.degree", "unit": "s", "better": "lower",
                                "bound": 0.05, "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({"name": "build_ms.degree", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Graph and plans",
                               "moves": "build_s.degree", "workloads": [CELL]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny, before


def run(root, trace=False, seconds=0.2, seed=2**31 + 7):
    return harness.run(root, CELL, seed, seconds, trace, CPU, time.perf_counter())[0]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_from_new_files_judges_itself(degree_cell, monkeypatch, trace):
    root, before = degree_cell

    def refused(*a, **kw):
        raise AssertionError("a runner with its own judge needs no SimRank reference")

    monkeypatch.setattr(simrank_reference, "simrank", refused)
    monkeypatch.setattr(check, "Reference", refused)
    out = run(root, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"] == {"degree_off": {"value": 0.0, "limit": 0},
                             "edges_off": {"value": 0.0, "limit": 0}}
    assert set(out["metrics"]) == ({"build_ms.degree"} if trace else {"build_s.degree", "setup_s"})
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_mode_comes_from_the_configuration(degree_cell):
    root, _ = degree_cell
    with pytest.raises(SystemExit, match="mode exact"):
        harness.run(root, CELL, 1, 0.0, False, CPU, time.perf_counter(), mode="fast")


def test_answer_off_at_one_node_reads_not_correct(degree_cell, monkeypatch):
    from graphtpu_torch.core import graph

    orig = graph.build_graph

    def off(*a, **kw):
        g = orig(*a, **kw)
        g.deg[3] += 1
        return g

    monkeypatch.setattr(graph, "build_graph", off)
    out = run(degree_cell[0])
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
    assert out["checks"]["degree_off"]["value"] == 1


def test_judge_that_returns_nothing_is_not_correct(degree_cell, monkeypatch):
    orig = harness.load_runner

    def silent(root, traffic):
        mod = orig(root, traffic)
        mod.judge = lambda state, kept: []
        return mod

    monkeypatch.setattr(harness, "load_runner", silent)
    out = run(degree_cell[0])
    assert not out["correct"], out["checks"]
    assert out["attempted"] >= 1
