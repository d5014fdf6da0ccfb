"""The stage clock (``graphtpu_torch.utils.metrics.StageClock``) and the
spans it puts on the profiler's timeline: its off path, one add per mark,
the plan's spans in ``exact_simrank_spmm``, and the stages, the looked-up
calls and the ``--profile`` trace of ``python -m graphtpu_torch simrank``."""

import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphtpu_torch.core.graph as tgraph
import graphtpu_torch.io.simfile as simfile
import graphtpu_torch.kernels.topk as topk
import graphtpu_torch.simrank.exact as exact
from graphtpu_torch.cli import main as t_main
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.utils.metrics import StageClock

torch.set_num_threads(1)

SOLVE_SPANS = {"plan", "product1", "transpose", "product2"}
CLI_STAGES = ["read", "simrank", "topk", "fetch", "write"]


class Counted(dict):
    """A ``stage_times`` that counts the assignments to each key."""

    def __init__(self):
        super().__init__()
        self.adds = {}

    def __setitem__(self, key, value):
        self.adds[key] = self.adds.get(key, 0) + 1
        super().__setitem__(key, value)


class FakeEvent:
    """A CUDA event on a host counter: each record a millisecond later."""

    now = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        FakeEvent.now += 1.0
        self.at = FakeEvent.now

    def elapsed_time(self, end):
        return end.at - self.at


def _edges():
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 48, (200, 2))
    return edges[edges[:, 0] != edges[:, 1]]


@pytest.fixture
def graph():
    return build_graph(_edges(), n_nodes=48)


@pytest.fixture
def graph_file(tmp_path):
    path = str(tmp_path / "g.txt")
    write_edgelist(path, _edges())
    return path


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of ``torch.profiler.record_function`` and of
    ``torch.cuda.synchronize`` (made a no-op)."""
    n = {"record_function": 0, "synchronize": 0}
    orig = torch.profiler.record_function

    def record_function(name, *a, **kw):
        n["record_function"] += 1
        return orig(name, *a, **kw)

    def synchronize(*a, **kw):
        n["synchronize"] += 1

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return n


def _profiled_names(fn):
    """The names of the CPU profiler's events while ``fn()`` runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _simrank_argv(graph_file, out, *extra):
    return ["simrank", "--input", graph_file, "--output", str(out), "--engine", "spmm",
            "--iterations", "2", "--topk", "5", "--device", "cpu", *extra]


@pytest.mark.parametrize("sync", [False, True])
def test_off_path_opens_no_range_and_syncs_nothing(calls, graph, sync):
    clock = StageClock(None, "cuda", sync=sync)

    def run():
        assert clock.stage("product1", lambda x: x + 1, 1) == 2
        with clock.span("plan"):
            pass
        clock.close()
        exact.exact_simrank_spmm(graph, SimRankConfig(iterations=2), device="cpu")

    names = _profiled_names(run)
    assert calls == {"record_function": 0, "synchronize": 0}
    assert not names & SOLVE_SPANS


def test_ranges_open_only_under_the_profiler(calls):
    times = {}
    clock = StageClock(times, "cpu")

    def run():
        clock.stage("a", lambda: None)
        with clock.span("b"):
            pass

    run()
    assert calls["record_function"] == 0 and set(times) == {"a", "b"}
    assert {"a", "b"} <= _profiled_names(run)
    assert calls == {"record_function": 2, "synchronize": 0}


def test_solve_adds_each_mark_on_its_own(graph):
    times = Counted()
    exact.exact_simrank_spmm(graph, SimRankConfig(iterations=30), device="cpu",
                             stage_times=times)
    assert times.adds == {"plan": 1, "layout_host": 1, "stream_host": 1, "product1": 30,
                          "transpose": 30, "product2": 30}


def test_cuda_marks_are_added_one_by_one_at_close(calls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    times = Counted()
    clock = StageClock(times, "cuda")
    for _ in range(30):
        clock.stage("product1", lambda: None)
    assert times.adds == {}  # the events are read once, in close()
    with clock.span("plan"):
        pass
    assert calls["synchronize"] == 1  # a span's end, on a card
    clock.close()
    assert times.adds == {"plan": 1, "product1": 30}
    assert times["product1"] == 30.0
    assert calls["synchronize"] == 2


def test_sync_form_times_between_two_synchronises(calls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", None)  # no event in this form
    times = Counted()
    clock = StageClock(times, "cuda", sync=True)
    assert clock.stage("wire", lambda: 7) == 7
    with clock.span("plan"):
        pass
    clock.close()
    assert times.adds == {"wire": 1, "plan": 1}
    assert calls["synchronize"] == 4


@pytest.mark.parametrize("impl", ["stream", "tree"])
def test_timed_solve_puts_its_spans_on_the_profile(graph, impl):
    cfg = SimRankConfig(iterations=2)
    timed = _profiled_names(lambda: exact.exact_simrank_spmm(
        graph, cfg, impl=impl, device="cpu", stage_times={}))
    assert SOLVE_SPANS <= timed
    untimed = _profiled_names(lambda: exact.exact_simrank_spmm(graph, cfg, impl=impl,
                                                               device="cpu"))
    assert not untimed & SOLVE_SPANS


@pytest.mark.parametrize("extra,stages", [
    ([], CLI_STAGES),
    (["--relabel", "rcm"], ["read", "relabel", *CLI_STAGES[1:]]),
])
def test_simrank_cli_prints_its_stages(tmp_path, graph_file, capsys, extra, stages):
    assert t_main(_simrank_argv(graph_file, tmp_path / "o.txt", *extra)) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.endswith("(kernel launches: kahan 0, fast 0)")
    assert [k for k, _ in re.findall(r"(\w+) ([\d.]+) s", line)] == stages


def test_cli_job_looks_up_each_call_once(tmp_path, graph_file, monkeypatch):
    """The benchmark's hooks: each of the four calls is found as a module
    attribute when the job runs, and the solve is handed no ``stage_times``
    of the CLI's (a wrapper may pass its own)."""
    n, times = {}, Counted()
    for mod, attr in ((tgraph, "read_edgelist_graph"), (exact, "exact_simrank_spmm"),
                      (topk, "topk_rows"), (simfile, "write_topk_files")):
        orig = getattr(mod, attr)
        extra = {"stage_times": times} if attr == "exact_simrank_spmm" else {}

        def counted(*a, _orig=orig, _attr=attr, _extra=extra, **kw):
            n[_attr] = n.get(_attr, 0) + 1
            return _orig(*a, **_extra, **kw)

        monkeypatch.setattr(mod, attr, counted)
    assert t_main(_simrank_argv(graph_file, tmp_path / "o.txt")) == 0
    assert n == {"read_edgelist_graph": 1, "exact_simrank_spmm": 1, "topk_rows": 1,
                 "write_topk_files": 1}
    assert times.adds["product1"] == 2


def test_profile_holds_the_jobs_stages(tmp_path, graph_file, capsys):
    prof = tmp_path / "prof"
    assert t_main(_simrank_argv(graph_file, tmp_path / "o.txt", "--profile", str(prof))) == 0
    assert capsys.readouterr().out.strip().endswith("(kernel launches: kahan 0, fast 0)")
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(CLI_STAGES) <= ranges
