"""The control: the program's own lower precision (``fast16``: bf16
iterates) in place of the configuration's must come out as not correct
through the harness's own verdict, where the configuration's precision
comes out correct, against each cell's limits."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT

CELLS = ["urand.gold-solve", "kron.gold-solve", "urand.cli-job", "kron.cli-job"]


def _control_fails(root, workload, seed, device):
    out = harness.run(root, workload, seed, 0.0, False, device, time.perf_counter(),
                      mode="fast16")[0]
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_control_fails_small(tiny, workload, seed):
    _control_fails(tiny, workload, seed, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    _control_fails(ROOT, workload, 2**31 + 101, card)
