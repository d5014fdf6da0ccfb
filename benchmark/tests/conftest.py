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
def watched(monkeypatch):
    """{"kept": the answers the runner's judge was given, "extra": what its
    ``numbers`` returned}, filled by the next run."""
    from benchmark import harness

    seen = {}
    load = harness.load_runner

    def load_watched(root, traffic):
        mod = load(root, traffic)
        judge, numbers = mod.judge, mod.numbers

        def judge_seen(state, kept):
            seen["kept"] = list(kept)
            return judge(state, kept)

        def numbers_seen(state, units):
            seen["extra"] = numbers(state, units)
            return seen["extra"]

        monkeypatch.setattr(mod, "judge", judge_seen)
        monkeypatch.setattr(mod, "numbers", numbers_seen)
        return mod

    monkeypatch.setattr(harness, "load_runner", load_watched)
    return seen


def walk_numbers_before_own_judge(root: Path, config: str, traffic: str, seed: int,
                                  kept, extra) -> dict:
    """The numbers of a Monte-Carlo run with answers ``kept`` and further
    numbers ``extra`` as they were read before the runner judged itself:
    the harness solved float64 SimRank at the mix's iterations and judged
    each answer against it, and ``numbers`` solved it again at the
    configuration's step for ``precision_short``."""
    import torch

    from benchmark import check
    from benchmark.gen.graphs import edges_of
    from benchmark.reference import simrank as reference
    from benchmark.runners.uniwalk import _precision_short

    cfg = json.loads((root / "benchmark" / "configs" / f"{config}.json").read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    n, sr = int(cfg["graph"]["n_nodes"]), cfg["simrank"]
    step = int(next(cfg[k]["step"] for k in ("uniwalk", "topsim") if k in cfg))
    edges = edges_of(cfg["graph"], seed)
    cpu = torch.device("cpu")
    ref = check.Reference(reference.simrank(edges, n, float(sr["c"]), int(mix["iterations"]),
                                            cpu), int(sr["topk"]))
    judged = [check.judge_topk(ref, vals, idx, 0) for vals, idx in kept]
    exact = reference.simrank(edges, n, float(sr["c"]), step, cpu)
    short = max(_precision_short(exact, idx, int(sr["topk"])) for _, idx in kept)
    return check.worst(judged + [dict(extra, precision_short=short)])


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
