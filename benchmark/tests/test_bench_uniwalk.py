"""The UniWalk cell (``urand.uniwalk-solve``) end to end on the CPU at a tiny
size: the result line, traced and untraced, and the controls of
``readings_uniwalk.py`` that must read as not correct."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

import graphtpu_torch.simrank.uniwalk as uw
from benchmark import harness
from benchmark.readings_uniwalk import CASES
from benchmark.reference import simrank as exact_reference
from benchmark.tests.conftest import walk_numbers_before_own_judge

torch.set_num_threads(2)
CPU = torch.device("cpu")
CELL = "urand.uniwalk-solve"
SAMPLE = 2_000
# The tiny copy (V = 256, one source tile) at SAMPLE 2,000 reads, over seeds
# 2**31 + 7, 3 and 5: score_err 0.65-0.75 and precision_short 0.541-0.543;
# at a quarter of SAMPLE 1.38-1.84 and 0.705-0.717; estimator_err 1e-7, and
# at least 1.6e-3 with bf16 item values, 2.7e-3 with bf16 scores and 0.71
# at three quarters of SAMPLE.  Each limit lies between.
LIMITS = {"score_err": 1.0, "precision_short": 0.62, "estimator_err": 1e-5,
          "estimator_rank_err": 1e-5, "bad_rows": 0, "walkers_short": 0, "hops_short": 0}
ESTIMATOR = {"estimator_err", "estimator_rank_err"}
SHORT = {"walkers_short", "hops_short"}


@pytest.fixture
def tiny_uniwalk(tiny):
    cfg_path = tiny / "benchmark" / "configs" / "urand-uniwalk.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["uniwalk"]["sample"] = SAMPLE
    cfg_path.write_text(json.dumps(cfg))
    lim_path = tiny / "benchmark" / "limits" / f"{CELL}.json"
    lim = json.loads(lim_path.read_text())
    lim["limits"] = LIMITS
    lim_path.write_text(json.dumps(lim))
    return tiny


def run(root, trace=False, seconds=0.0, seed=2**31 + 7, mode=None):
    return harness.run(root, CELL, seed, seconds, trace, CPU, time.perf_counter(), mode=mode)[0]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_cell_reaches_its_result(tiny_uniwalk, trace, seed):
    out = run(tiny_uniwalk, trace, seconds=0.3, seed=seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = json.loads((tiny_uniwalk / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind] if CELL in m.get("workloads", [CELL])}
    got = set(out["metrics"])
    assert got <= mine
    if trace:
        # the device's idle share needs a card's trace
        assert got == mine - {"idle_share.uniwalk"}
    else:
        assert got == {"solve_s", "setup_s"}
    for name in SHORT:
        assert out["checks"][name] == {"value": 0.0, "limit": 0}
    assert ESTIMATOR | {"precision_short"} <= set(out["checks"])


@pytest.mark.parametrize("case,fails", [
    ("sample25", {"score_err", "precision_short"} | ESTIMATOR | SHORT),
    ("sample75", ESTIMATOR | SHORT),
    ("bf16", ESTIMATOR),
    ("bf16_answer", {"estimator_err"}),
    ("drop_tile", {"bad_rows", "precision_short"}),
])
def test_control_reads_not_correct(tiny_uniwalk, case, fails):
    with CASES[case]():
        out = run(tiny_uniwalk)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1 or case in ("sample75", "bf16", "bf16_answer")
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert over == fails, out["checks"]


def test_traced_run_counts_a_cut_sample(tiny_uniwalk):
    with CASES["sample25"]():
        out = run(tiny_uniwalk, trace=True)
    assert out["checks"]["walkers_short"]["value"] == 256 * SAMPLE * 3 // 4
    assert out["checks"]["hops_short"]["value"] == 256 * SAMPLE * 3 // 4 * 10
    assert not out["correct"]


def _fewer_walkers(orig):
    return lambda g, src, key, sample, step: orig(g, src, key, sample // 2, step)


def _last_step_dead(orig):
    def cut(g, src, key, sample, step):
        w = orig(g, src, key, sample, step).clone()
        w[..., -2:] = -1
        return w
    return cut


@pytest.mark.parametrize("cut,short", [
    (_fewer_walkers, {"walkers_short": 256 * SAMPLE // 2, "hops_short": 256 * SAMPLE // 2 * 10}),
    (_last_step_dead, {"walkers_short": 0, "hops_short": 256 * SAMPLE * 10}),
])
def test_cut_inside_the_walks_stage_reads_not_correct(tiny_uniwalk, monkeypatch, cut, short):
    """Work left out inside the program's walk stage, past the entry: the
    counts of the walks made, and the tile made anew from its key, see it."""
    monkeypatch.setattr(uw, "_tile_walks", cut(uw._tile_walks))
    out = run(tiny_uniwalk)
    assert {k: out["checks"][k]["value"] for k in SHORT} == short
    assert out["checks"]["estimator_err"]["value"] > LIMITS["estimator_err"]
    assert not out["correct"]


def test_runner_refuses_other_precisions_and_steps(tiny_uniwalk):
    with pytest.raises(SystemExit, match="mode fast"):
        run(tiny_uniwalk, mode="kahan")
    path = tiny_uniwalk / "benchmark" / "traffic" / "uniwalk-solve.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, iterations=4)))
    with pytest.raises(SystemExit, match="step 5"):
        run(tiny_uniwalk)


def test_exact_simrank_solved_once(tiny_uniwalk, monkeypatch):
    """The runner's judge solves the exact reference, and ``numbers`` reads
    that solve: the harness builds none of its own."""
    calls = []
    orig = exact_reference.simrank

    def counted(*a, **kw):
        calls.append(a[2:4])
        return orig(*a, **kw)

    monkeypatch.setattr(exact_reference, "simrank", counted)
    out = run(tiny_uniwalk, seconds=0.3)
    assert out["correct"], out["checks"]
    assert calls == [(0.6, 5)]


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_checks_equal_the_parents(tiny_uniwalk, watched, seed):
    """Every number of one run, each held to a limit of 1e9 so that the
    checks show it, equals what the path before the runner's own judge
    reads from the same run's answers (two exact solves there, one here)."""
    path = tiny_uniwalk / "benchmark" / "limits" / f"{CELL}.json"
    names = {"score_err", "score_abs", "rank_err", *LIMITS}
    path.write_text(json.dumps({"limits": {n: 1e9 for n in names}}))
    out = run(tiny_uniwalk, seed=seed)
    want = walk_numbers_before_own_judge(tiny_uniwalk, "urand-uniwalk", "uniwalk-solve", seed,
                                         watched["kept"], watched["extra"])
    assert len(watched["kept"]) >= 1 and set(want) == names
    assert {n: c["value"] for n, c in out["checks"].items()} == want


def test_idle_share_reads_the_unprofiled_solves():
    """The device's busy time a profiled solve over the median unprofiled
    solve: unit 1 (profiled, twice as slow) is not in the median."""
    reader = harness.load_file(Path(__file__).parents[1] / "metrics" / "idle_share.uniwalk.py",
                               "idle_share_uniwalk")
    rec = {"traffic": {"trace_units": 1}, "unit_s": [1.30, 2.60, 1.28, 1.30, 1.32],
           "busy_s": 1.235}
    assert reader.read(rec) == pytest.approx(5.0)
    assert reader.read(dict(rec, traffic={"trace_units": 2}, busy_s=2.47)) == pytest.approx(5.0)
    assert reader.read(dict(rec, busy_s=None)) is None
