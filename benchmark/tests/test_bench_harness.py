"""The harness end to end on the CPU at a tiny size: the result line,
discovery of new cells by name, and the faults that must read as not
correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT

CPU = torch.device("cpu")
CELLS = ["urand.gold-solve", "kron.gold-solve", "urand.cli-job", "kron.cli-job"]
SOLVES = [w for w in CELLS if w.endswith("gold-solve")]


def run(root, workload, trace=False, seconds=0.3, seed=2**31 + 7, mode=None):
    return harness.run(root, workload, seed, seconds, trace, CPU, time.perf_counter(),
                       mode=mode)[0]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_reaches_its_result(tiny, workload, trace):
    out = run(tiny, workload, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) <= mine
    assert "setup_s" in out["metrics"] or trace
    assert json.loads(json.dumps(out)) == out


def test_same_seed_same_graph(tiny):
    a = run(tiny, "kron.gold-solve", seconds=0.0, seed=5)
    b = run(tiny, "kron.gold-solve", seconds=0.0, seed=5)
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_solve_counts_its_iterations(tiny, workload):
    out = run(tiny, workload, trace=True)
    assert out["checks"]["iterations_short"] == {"value": 0.0, "limit": 0}
    assert "iterations_short" not in run(tiny, workload)["checks"]


def test_new_cell_from_new_files_only(tiny):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and entries run with no edit to a file that was there."""
    before = {p: p.read_bytes() for p in (tiny / "benchmark").rglob("*") if p.is_file()}
    b = tiny / "benchmark"
    (b / "configs" / "ring-simrank.json").write_text(json.dumps({
        "graph": {"generator": "urand", "scale": 7, "edge_factor": 6, "n_nodes": 128},
        "simrank": {"c": 0.8, "topk": 5, "mode": "kahan"}}))
    mix = json.loads((b / "traffic" / "gold-solve.json").read_text())
    mix.update(iterations=4)
    (b / "traffic" / "short-solve.json").write_text(json.dumps(mix))
    (b / "metrics" / "units_per_s.solve.py").write_text(
        "def read(rec):\n    return rec['units'] / rec['window_s']\n")
    (b / "limits" / "ring.short-solve.json").write_text(
        json.dumps({"limits": {"score_err": 1e-5, "rank_err": 1e-5, "bad_rows": 0}}))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ring-simrank", "source": "test",
                             "file": "benchmark/configs/ring-simrank.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "ring.short-solve", "config": "ring-simrank",
                               "traffic": "short-solve", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "units_per_s.solve", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["ring.short-solve"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run(tiny, "ring.short-solve")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"units_per_s.solve", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _state_unchanged(monkeypatch):
    """Every product returns its table: the iteration leaves S as it was."""
    import graphtpu_torch.simrank.exact as exact

    def spmv(stream, table, mode="kahan", table_scale=None):
        return torch.cat([table[: stream.n_nodes], table.new_zeros(1, table.shape[1])])

    monkeypatch.setattr(exact, "spmv", spmv)


def _score_altered(monkeypatch):
    """One score of the top-k, raised by 1% where the top-k is made."""
    import graphtpu_torch.kernels.topk as topk
    import graphtpu_torch.simrank.exact as exact

    orig = topk.topk_rows

    def topk_rows(scores, k, **kw):
        vals, idx = orig(scores, k, **kw)
        vals = vals.clone()
        vals[3, 0] *= 1.01
        return vals, idx

    monkeypatch.setattr(topk, "topk_rows", topk_rows)
    monkeypatch.setattr(exact, "topk_rows", topk_rows)


def _id_altered(monkeypatch):
    """The best id of one row replaced by its last, where the top-k is made."""
    import graphtpu_torch.kernels.topk as topk
    import graphtpu_torch.simrank.exact as exact

    orig = topk.topk_rows

    def topk_rows(scores, k, **kw):
        vals, idx = orig(scores, k, **kw)
        idx = idx.clone()
        idx[3, 0] = idx[3, -1]
        return vals, idx

    monkeypatch.setattr(topk, "topk_rows", topk_rows)
    monkeypatch.setattr(exact, "topk_rows", topk_rows)


def _file_altered(monkeypatch):
    """One written score off by 1e-4, where the file is written."""
    import graphtpu_torch.io.simfile as simfile

    orig = simfile.write_topk_files

    def write_topk_files(path, indices, scores, *a, **kw):
        scores = np.array(scores, copy=True)
        scores[5, 2] += 1e-4
        return orig(path, indices, scores, *a, **kw)

    monkeypatch.setattr(simfile, "write_topk_files", write_topk_files)


def _iterations_cut(monkeypatch):
    """The solve cut to two thirds of its iterations."""
    import dataclasses

    import graphtpu_torch.simrank.exact as exact

    orig = exact.exact_simrank_spmm

    def cut(g, cfg, *a, **kw):
        return orig(g, dataclasses.replace(cfg, iterations=2 * cfg.iterations // 3), *a, **kw)

    monkeypatch.setattr(exact, "exact_simrank_spmm", cut)


FAULTS = [(w, f) for w in CELLS for f in (_state_unchanged, _score_altered, _id_altered)]
FAULTS += [(w, _file_altered) for w in CELLS if w.endswith("cli-job")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_reads_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run(tiny, workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("workload", SOLVES)
def test_traced_run_sees_a_cut_solve(tiny, monkeypatch, workload):
    _iterations_cut(monkeypatch)
    out = run(tiny, workload, trace=True)
    assert out["checks"]["iterations_short"]["value"] == 10
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [w for w in CELLS if w.endswith("cli-job")])
def test_cli_job_sees_a_cut_solve(tiny, monkeypatch, workload):
    _iterations_cut(monkeypatch)
    out = run(tiny, workload, trace=True)
    assert out["checks"]["iterations_short"]["value"] == 10
    assert not out["correct"], out["checks"]


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                        "urand.gold-solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
