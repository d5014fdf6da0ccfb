"""The metrics that read the program's own spans (``plan_total_ms.*``,
``stream_ms.solve``), and the program's ``record_function`` ranges kept
out of the device's busy time."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness, trace
from benchmark.tests.conftest import ROOT

CPU = torch.device("cpu")
READERS = {"plan_total_ms.solve": "plan", "stream_ms.solve": "stream_host",
           "plan_total_ms.job": "plan"}
PROGRAM_SPANS = ("plan", "product1", "transpose", "product2")


def reader(name):
    return harness.load_file(ROOT / "benchmark" / "metrics" / f"{name}.py",
                             "benchmark_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,key", READERS.items())
def test_reader_takes_the_median_of_the_unprofiled_units(name, key):
    rec = {"stages": [{key: 3.0, "product1": 1.0}, {key: 9.0}, {key: 4.0}, {"product1": 2.0}]}
    assert reader(name).read(rec) == 4.0
    assert reader(name).read({"stages": [{"product1": 1.0, "layout_host": 0.5}]}) is None
    assert reader(name).read({"stages": []}) is None


@pytest.mark.parametrize("workload,names", [
    ("urand.gold-solve", {"plan_total_ms.solve", "stream_ms.solve"}),
    ("kron.gold-solve", {"plan_total_ms.solve", "stream_ms.solve"}),
    ("urand.cli-job", {"plan_total_ms.job"}),
])
def test_traced_run_reports_the_plan(tiny, workload, names):
    out = harness.run(tiny, workload, 2**31 + 11, 0.3, True, CPU, time.perf_counter())[0]
    assert out["correct"], out["checks"]
    for name in names:
        assert out["metrics"][name]["value"] > 0 and out["metrics"][name]["unit"] == "ms"
    if workload.endswith("gold-solve"):
        m = out["metrics"]
        assert m["stream_ms.solve"]["value"] < m["plan_total_ms.solve"]["value"]


@pytest.mark.cuda
def test_program_ranges_are_not_device_time(card, tmp_path):
    """For a timed solve under the profiler, the device intervals are the
    union of its kernels, copies and sets alone, and no device operation
    bears the name of one of the program's spans."""
    import numpy as np

    from benchmark.gen.graphs import edges_of
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.graph import build_graph
    from graphtpu_torch.simrank.exact import exact_simrank_spmm

    cfg = json.loads((ROOT / "benchmark" / "configs" / "urand-simrank.json").read_text())
    graph = dict(cfg["graph"], scale=12, n_nodes=4096)
    g = build_graph(np.asarray(edges_of(graph, 5)), n_nodes=4096, device=card)
    exact_simrank_spmm(g, SimRankConfig(iterations=2), device=card)  # warm-up
    torch.cuda.synchronize(card)
    with harness._profile(card) as prof:
        exact_simrank_spmm(g, SimRankConfig(iterations=3), device=card, stage_times={})
        torch.cuda.synchronize(card)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = prof.events()
    names = dict.fromkeys(["unit"])
    got = trace.device_intervals(events, names)
    chrome = json.loads(path.read_text())["traceEvents"]
    cats = {e.get("cat") for e in chrome}
    assert "gpu_user_annotation" in cats  # the program's ranges reached the device trace
    work = [e for e in chrome if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    want = trace._merged([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in work])
    assert len(got) == len(want)
    rel = [(a - got[0][0], b - got[0][0]) for a, b in got]
    rel_want = [(a - want[0][0], b - want[0][0]) for a, b in want]
    np.testing.assert_allclose(np.asarray(rel), np.asarray(rel_want), atol=2.0)  # us
    ops = {name for name, _ in trace.top_device_ops(events, names, n=1000)}
    assert not ops & set(PROGRAM_SPANS)
