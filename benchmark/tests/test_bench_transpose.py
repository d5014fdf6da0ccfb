"""``transpose_ms.solve``: the program's "transpose" stage over the
iterations, median over the unprofiled solves; reported by a traced
gold-solve run."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT


def reader():
    return harness.load_file(ROOT / "benchmark" / "metrics" / "transpose_ms.solve.py",
                             "benchmark_metric_transpose_ms_solve")


def test_reader_takes_the_median_per_iteration():
    rec = {"traffic": {"iterations": 30},
           "stages": [{"transpose": 300.0, "product1": 1.0}, {"transpose": 90.0},
                      {"transpose": 150.0}, {"product1": 2.0}]}
    assert reader().read(rec) == 5.0
    assert reader().read({"traffic": {"iterations": 30}, "stages": [{"plan": 1.0}]}) is None
    assert reader().read({"traffic": {"iterations": 30}, "stages": []}) is None


@pytest.mark.parametrize("workload", ["urand.gold-solve", "kron.gold-solve"])
def test_traced_gold_solve_reports_the_transpose(tiny, workload):
    out = harness.run(tiny, workload, 2**31 + 13, 0.3, True, torch.device("cpu"),
                      time.perf_counter())[0]
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["transpose_ms.solve"]["unit"] == "ms"
    assert 0 < m["transpose_ms.solve"]["value"] < m["iter_ms.solve"]["value"]
