"""Fixtures of the benchmark's tests: a copy of the benchmark's data files
with every configuration cut to a graph that the CPU runs in a second."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "metrics", "runners", "limits")
TINY = {"urand": {"scale": 8, "n_nodes": 256}, "kron": {"scale": 8, "n_nodes": 256}}


def tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and the benchmark's data files,
    each configuration's graph cut to a tiny size."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for d in DATA_DIRS:
        shutil.copytree(ROOT / "benchmark" / d, dest / "benchmark" / d)
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["graph"].update(TINY[cfg["graph"]["generator"]])
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
