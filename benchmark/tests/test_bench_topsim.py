"""The TopSim cell (``urand.topsim-solve``) end to end on the CPU at a tiny
size: the result line, traced and untraced, the controls of
``readings_topsim.py`` that must read as not correct, and the refusals."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import graphtpu_torch.simrank.topsim as ts
from benchmark import harness
from benchmark.readings_topsim import CASES
from benchmark.reference import simrank as exact_reference
from benchmark.tests.conftest import walk_numbers_before_own_judge

torch.set_num_threads(2)
CPU = torch.device("cpu")
CELL = "urand.topsim-solve"
SAMPLE = 1_000
# The tiny copy (V = 256, eight source tiles) at SAMPLE 1,000 reads, over
# seeds 2**31 + 7, 3 and 5: precision_short 0.507-0.523, at a quarter of
# SAMPLE 0.757-0.759, with a tile dropped 0.583; estimator_err ~1e-7, and
# 1.67-1.82 at a quarter of SAMPLE; spread_bad 0, and 13,431 with W cut to
# SAMPLE, 94,106 with every parent sampled, 24,036 with bf16 mass (seed 3).
# Each limit lies between.
LIMITS = {"precision_short": 0.6, "estimator_err": 1e-5, "estimator_rank_err": 1e-5,
          "bad_rows": 0, "spread_bad": 0, "dropped_mass": 0}
TRACED = {"sources_short": 0}
ESTIMATOR = {"estimator_err", "estimator_rank_err"}


@pytest.fixture
def tiny_topsim(tiny):
    cfg_path = tiny / "benchmark" / "configs" / "urand-topsim.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["topsim"]["sample"] = SAMPLE
    cfg_path.write_text(json.dumps(cfg))
    lim_path = tiny / "benchmark" / "limits" / f"{CELL}.json"
    lim_path.write_text(json.dumps({"limits": LIMITS, "traced_limits": TRACED}))
    return tiny


def run(root, trace=False, seconds=0.0, seed=2**31 + 7, mode=None):
    return harness.run(root, CELL, seed, seconds, trace, CPU, time.perf_counter(), mode=mode)[0]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_cell_reaches_its_result(tiny_topsim, trace, seed):
    out = run(tiny_topsim, trace, seconds=0.3, seed=seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = json.loads((tiny_topsim / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind] if CELL in m.get("workloads", [CELL])}
    got = set(out["metrics"])
    if trace:
        # the device's idle share needs a card's trace
        assert got == mine - {"idle_share.topsim"}
        assert 0 < out["metrics"]["fill_share.topsim"]["value"] < 100
        assert out["checks"]["sources_short"] == {"value": 0.0, "limit": 0}
    else:
        assert got == {"solve_s", "setup_s"}
        assert "sources_short" not in out["checks"]
    assert {"spread_bad", "dropped_mass", "precision_short"} | ESTIMATOR <= set(out["checks"])
    assert out["checks"]["spread_bad"]["value"] == 0 == out["checks"]["dropped_mass"]["value"]


@pytest.mark.parametrize("case,fails", [
    ("sample25", {"precision_short"} | ESTIMATOR),
    ("w_cut", {"spread_bad", "dropped_mass"}),
    ("sampled", {"spread_bad", "precision_short"}),
    ("bf16_mass", {"spread_bad"}),
    ("drop_tile", {"bad_rows"}),
])
def test_control_reads_not_correct(tiny_topsim, case, fails):
    with CASES[case]():
        out = run(tiny_topsim)
    assert not out["correct"], out["checks"]
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert over == fails, out["checks"]


def test_traced_run_counts_the_sources(tiny_topsim, monkeypatch):
    """A solve that leaves its last tile out: the sources counted see it."""
    orig = ts.topsim_simrank

    def short(g, cfg, *a, sources=None, **kw):
        vals, idx = orig(g, cfg, *a, sources=np.arange(g.n_nodes - 32), **kw)
        return np.pad(vals, ((0, 32), (0, 0))), np.pad(idx, ((0, 32), (0, 0)), constant_values=-1)

    monkeypatch.setattr(ts, "topsim_simrank", short)
    out = run(tiny_topsim, trace=True)
    assert out["checks"]["sources_short"]["value"] == 32
    assert not out["correct"]


def test_runner_refuses_other_precisions_steps_and_programs(tiny_topsim, monkeypatch):
    with pytest.raises(SystemExit, match="mode fast"):
        run(tiny_topsim, mode="kahan")
    path = tiny_topsim / "benchmark" / "traffic" / "topsim-solve.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, iterations=4)))
    with pytest.raises(SystemExit, match="step 3"):
        run(tiny_topsim)
    path.write_text(json.dumps(mix))
    monkeypatch.delattr(ts, "TOPSIM_COUNTS")  # a program before the counters
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="TOPSIM_COUNTS"):
        run(tiny_topsim)
    assert time.perf_counter() - t0 < 5


def test_exact_simrank_solved_once(tiny_topsim, monkeypatch):
    """The runner's judge solves the exact reference, and ``numbers`` reads
    that solve: the harness builds none of its own."""
    calls = []
    orig = exact_reference.simrank

    def counted(*a, **kw):
        calls.append(a[2:4])
        return orig(*a, **kw)

    monkeypatch.setattr(exact_reference, "simrank", counted)
    out = run(tiny_topsim, seconds=0.3)
    assert out["correct"], out["checks"]
    assert calls == [(0.6, 3)]


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_checks_equal_the_parents(tiny_topsim, watched, seed):
    """Every number of one run, each held to a limit of 1e9 so that the
    checks show it, equals what the path before the runner's own judge
    reads from the same run's answers (two exact solves there, one here)."""
    path = tiny_topsim / "benchmark" / "limits" / f"{CELL}.json"
    names = {"score_err", "score_abs", "rank_err", *LIMITS}
    path.write_text(json.dumps({"limits": {n: 1e9 for n in names}}))
    out = run(tiny_topsim, seed=seed)
    want = walk_numbers_before_own_judge(tiny_topsim, "urand-topsim", "topsim-solve", seed,
                                         watched["kept"], watched["extra"])
    assert len(watched["kept"]) >= 1 and set(want) == names
    assert {n: c["value"] for n, c in out["checks"].items()} == want


def test_fill_share_reads_the_counted_solves():
    reader = harness.load_file(Path(__file__).parents[1] / "metrics" / "fill_share.topsim.py",
                               "fill_share_topsim")
    rec = {"stages": [{"live": 30.0, "slots": 100.0}, {"live": 40.0, "slots": 100.0},
                      {"live": 36.0, "slots": 100.0}, {"expand": 1.0}]}
    assert reader.read(rec) == pytest.approx(36.0)
    assert reader.read({"stages": []}) is None
