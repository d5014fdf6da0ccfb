"""The node2vec cell (``kron14.node2vec-job``) end to end on the CPU at a
tiny size: the result line, traced and untraced, the controls of
``readings_node2vec.py`` that must read as not correct, a copy of the
benchmark without the cell's files that gains the cell from new files and
entries alone, the refusal of a program without the counters, and the
cell's metric readers and byte count."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

import graphtpu_torch.walks.node2vec as n2v
from benchmark import harness, roofline_node2vec
from benchmark.readings_node2vec import CASES

torch.set_num_threads(2)
CPU = torch.device("cpu")
CELL = "kron14.node2vec-job"
# The tiny copy (V = 256) at d = 16, with the published walks (10 x 80,
# window 10; 625 steps of 256 centers) reads, over seeds 2**31 + 7, 3 and
# 5: hop_share_err 1.6e-3 to 1.7e-3, step_err 1e-6 to 2e-6, auc_gap 7.0e-3
# to 2.1e-2, and a tenth of the steps 0.083 to 0.20.  With the walks cut
# to 2 x 20 and a window of 5 (31 steps; SHORT): hop_share_err 1.9e-3 to
# 4.8e-3, and 0.218 to 0.222 at p = q = 1; step_err 1.2e-5 to 2.1e-5, and
# 3.4e-3 to 3.7e-3 with bfloat16 gradients; auc_gap up to 0.019, where a
# tenth of the steps reads no more.  Each limit lies between.
LIMITS = {"bad_hops": 0, "bad_starts": 0, "hop_share_err": 0.02, "step_err": 3e-4,
          "auc_gap": 0.05, "emb_bad": 0}
TRACED = {"steps_short": 0, "hops_short": 0}
WIDTH = {"dimensions": 16}
SHORT = {"dimensions": 16, "num_walks": 2, "walk_length": 20, "window": 5}
NEW = {"configs": ["kron14-node2vec.json"], "traffic": ["node2vec-job.json"],
       "runners": ["node2vec.py"], "limits": [f"{CELL}.json"],
       "metrics": [f"{m}.node2vec.py" for m in ("walks_ms", "sgns_ms", "write_ms",
                                                "trials_per_hop", "step_roofline",
                                                "idle_share")]}


def _cut(root: Path, cut: dict) -> Path:
    path = root / "benchmark" / "configs" / "kron14-node2vec.json"
    cfg = json.loads(path.read_text())
    cfg["node2vec"].update(cut)
    path.write_text(json.dumps(cfg))
    lim = root / "benchmark" / "limits" / f"{CELL}.json"
    lim.write_text(json.dumps({"limits": LIMITS, "traced_limits": TRACED}))
    return root


@pytest.fixture
def short(tiny):
    return _cut(tiny, SHORT)


def run(root, trace=False, seconds=0.0, seed=2**31 + 7, mode=None):
    return harness.run(root, CELL, seed, seconds, trace, CPU, time.perf_counter(), mode=mode)[0]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_reaches_its_result(short, trace):
    out = run(short, trace, seconds=0.2)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = json.loads((short / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind] if CELL in m.get("workloads", [CELL])}
    if trace:
        # the card's idle share needs a card's trace
        assert set(out["metrics"]) == mine - {"idle_share.node2vec"}
        assert out["metrics"]["trials_per_hop.node2vec"]["value"] >= 1
        assert {k: c["value"] for k, c in out["checks"].items() if k in TRACED} == {
            "steps_short": 0.0, "hops_short": 0.0}
    else:
        # peak_gb is read from a card
        assert set(out["metrics"]) == {"job_s", "setup_s"} == mine - {"peak_gb"}
        assert not TRACED.keys() & out["checks"].keys()
    assert set(LIMITS) <= set(out["checks"])


@pytest.mark.parametrize("case,cut,fails", [
    ("pq1", SHORT, {"hop_share_err"}),
    ("bf16_grads", SHORT, {"step_err"}),
    ("tenth", WIDTH, {"auc_gap"}),
])
def test_control_reads_not_correct(tiny, case, cut, fails):
    root = _cut(tiny, cut)
    with CASES[case]():
        out = run(root)
    assert not out["correct"], out["checks"]
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert over == fails, out["checks"]


def test_cell_from_new_files_alone(tiny):
    """The benchmark as it was without the cell gains it from new files and
    entries: no byte of a file that was there changes."""
    b = tiny / "benchmark"
    saved = tiny / "saved"
    for d, names in NEW.items():
        (saved / d).mkdir(parents=True)
        for name in names:
            shutil.move(b / d / name, saved / d / name)
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    mine = json.loads(json.dumps(bench))
    bench["configs"] = [c for c in bench["configs"] if c["name"] != "kron14-node2vec"]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    bench["per_layer"] = [m for m in bench["per_layer"] if not m["name"].endswith(".node2vec")]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    for d, names in NEW.items():
        for name in names:
            shutil.move(saved / d / name, b / d / name)
    # the cell's entries go at the ends of their lists
    for key in ("configs", "workloads", "per_layer"):
        assert mine[key][:len(bench[key])] == bench[key]
    for old, new in zip(bench["end_to_end"], mine["end_to_end"]):
        assert {k: v for k, v in new.items() if k != "workloads"} == {
            k: v for k, v in old.items() if k != "workloads"}
        assert new.get("workloads", [])[:len(old.get("workloads", []))] == old.get("workloads", [])
    (tiny / "BENCHMARK.json").write_text(json.dumps(mine))
    out = run(_cut(tiny, SHORT))
    assert out["correct"], out["checks"]
    for p, data in before.items():
        if p.name not in {"kron14-node2vec.json", f"{CELL}.json"}:  # cut above, as every test's
            assert p.read_bytes() == data, p


@pytest.mark.parametrize("name", ["NODE2VEC_COUNTS", "SgnsSteps"])
def test_program_without_the_counters_is_refused(short, monkeypatch, name):
    import graphtpu_torch.models.sgns as sgns

    monkeypatch.delattr(n2v if name == "NODE2VEC_COUNTS" else sgns, name)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="NODE2VEC_COUNTS"):
        run(short)
    assert time.perf_counter() - t0 < 5


def test_runner_refuses_a_precision_mode(short):
    with pytest.raises(SystemExit, match="float32"):
        run(short, mode="fast")


def _reader(name):
    return harness.load_file(Path(__file__).parents[1] / "metrics" / f"{name}.py",
                             "reader_" + name.replace(".", "_"))


def test_readers_take_the_unprofiled_jobs():
    stages = [{"walks": 100.0, "sgns": 1500.0, "write": 20.0, "n_hops": 1000.0,
               "n_proposals": 8000.0, "n_steps": 10.0, "n_centers": 81920.0,
               "n_negatives": 409600.0, "n_nodes": 16384.0},
              {"walks": 120.0, "sgns": 1700.0, "write": 30.0, "n_hops": 1000.0,
               "n_proposals": 9000.0, "n_steps": 10.0, "n_centers": 81920.0,
               "n_negatives": 409600.0, "n_nodes": 16384.0}]
    rec = {"stages": stages, "config": {"node2vec": {"dimensions": 128, "window": 10}},
           "traffic": {"trace_units": 1}, "unit_s": [2.0, 9.0, 2.2], "busy_s": 1.05}
    assert _reader("walks_ms.node2vec").read(rec) == pytest.approx(110.0)
    assert _reader("sgns_ms.node2vec").read(rec) == pytest.approx(1600.0)
    assert _reader("write_ms.node2vec").read(rec) == pytest.approx(25.0)
    assert _reader("trials_per_hop.node2vec").read(rec) == pytest.approx(8.5)
    step = roofline_node2vec.steps_ms(10, 81920, 409600, 16384, 128, 10)
    assert _reader("step_roofline.node2vec").read(rec) == pytest.approx(
        100 * step * (1 / 1500 + 1 / 1700) / 2)
    # the profiled job (index 1) is left out of the median
    assert _reader("idle_share.node2vec").read(rec) == pytest.approx(100 * (1 - 1.05 / 2.1))
    empty = {"stages": [], "config": rec["config"], "traffic": rec["traffic"], "unit_s": [2.0],
             "busy_s": None}
    assert all(_reader(f"{m}.node2vec").read(empty) is None
               for m in ("walks_ms", "sgns_ms", "write_ms", "trials_per_hop", "step_roofline",
                         "idle_share"))


def test_step_bytes_hand_count():
    # V = 16,384, D = 128, w = 10, B = 8,192, N = 5, one step: both tables
    # read and written (4 x 8.39 MB), B int32 centers, 2wB int32 contexts
    # and their bool mask, NB int32 negatives
    tables = 4 * 16384 * 128 * 4
    batch = 8192 * 4 + 8192 * 20 * 5 + 8192 * 5 * 4
    assert roofline_node2vec.steps_bytes(1, 8192, 40960, 16384, 128, 10) == tables + batch
    assert roofline_node2vec.steps_ms(1, 8192, 40960, 16384, 128, 10) == pytest.approx(
        (tables + batch) / 3.35e12 * 1e3)
    assert roofline_node2vec.steps_ms(1, 8192, 40960, 16384, 128, 10) == pytest.approx(0.01032,
                                                                                      abs=1e-5)
