"""One run of one cell: set up, warm up, measure a window, judge, report.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by its name in ``BENCHMARK.json``:

* ``benchmark/configs/<config>.json``: the graph's generator and sizes
  (``graph``) and what the program computes on it: for SimRank a
  ``simrank`` block (``c``, ``topk``, the precision ``mode``), otherwise
  the configuration's own keys, which its runner reads;
* ``benchmark/traffic/<mix>.json``: the mix's parameters, among them the
  ``runner`` (``benchmark/runners/<runner>.py``) that runs one unit of
  work, the SimRank mixes' ``iterations``, and the spans of the traced run;
* ``benchmark/metrics/<metric>.py``: ``read(rec)`` of one metric, which
  returns None where the run has nothing to read;
* ``benchmark/limits/<cell>.json``: the limit of each number compared.

A runner module has ``setup(ctx) -> state``, ``unit(state, rec) ->
answer or None``, ``judge(state, kept) -> [{name: x}, ...]`` and
``release(state)``, and may have ``numbers(state, units) -> {name: x}``,
further numbers compared.  ``judge`` gives one dict of numbers for each
kept answer, each against a reference that the runner owns (a plain one
under ``benchmark/reference/``; for top-k SimRank rows,
``check.judge_simrank``); the harness calls it after the window, before
``numbers`` and ``release``, and a judge that returns no dict is never
correct.  A limits file's ``limits`` hold in every run, its
``traced_limits`` in the traced run too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, trace
from benchmark.gen.graphs import edges_of
from benchmark.reference import simrank as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "graphtpu")


@dataclasses.dataclass
class Context:
    """What a runner gets: the cell's files, the seed's graph, the device."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    trace: bool
    mode: Optional[str]
    edges: np.ndarray
    n_nodes: int
    tmpdir: str


def load_file(path: Path, name: str):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, workload: str):
    """(BENCHMARK.json, the cell, its config file, its traffic file)."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {', '.join(sorted(cells))}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(root / cfg_entry["file"])
    traffic = _json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def load_runner(root: Path, traffic: dict):
    """The runner module that the traffic mix names."""
    return load_file(root / "benchmark" / "runners" / f"{traffic['runner']}.py",
                     f"benchmark_runner_{traffic['runner']}")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans around module attributes the program calls, for
    the traced run: each call of ``module:attr`` is timed (synchronised at
    its end where ``sync``) and marked for the profiler."""

    def __init__(self, spec: Dict[str, dict], device: torch.device):
        self.spec = spec
        self.device = device
        self.ms: Dict[str, List[float]] = {name: [] for name in spec}
        self.saved: List[tuple] = []

    def _wrap(self, name: str, fn: Callable, sync: bool) -> Callable:
        def timed(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kw)
                if sync:
                    _sync(self.device)
            self.ms[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def __enter__(self):
        for name, s in self.spec.items():
            mod_name, attr = s["call"].split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(name, orig, bool(s.get("sync", False))))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved.clear()


class _GcClock:
    """The seconds the garbage collector ran while it is entered."""

    def __init__(self):
        self.seconds = 0.0
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run(root: Path, workload: str, seed: int, seconds: float, trace_on: bool,
        device: torch.device, t_start: float, mode: Optional[str] = None):
    """One run of ``workload``: (the result line's object, {the seconds of
    each unit of the window, of garbage collection in the window, and of
    each part of set-up}).  ``mode`` replaces the configuration's precision: the control,
    as ``readings.py`` and the tests run it."""
    bench, cell, config, traffic = find_cell(root, workload)
    bdir = root / "benchmark"
    runner = load_runner(root, traffic)
    lim = _json(bdir / "limits" / f"{workload}.json")
    limits = dict(lim["limits"], **(lim.get("traced_limits", {}) if trace_on else {}))
    graph = config["graph"]
    n_nodes = int(graph["n_nodes"])
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
        _sync(device)
    marks.append(("context", time.perf_counter()))
    with tempfile.TemporaryDirectory(prefix="bench-") as tmpdir:
        ctx = Context(config=config, traffic=traffic, seed=seed, device=device, trace=trace_on,
                      mode=mode or config.get("simrank", {}).get("mode"),
                      edges=edges_of(graph, seed), n_nodes=n_nodes, tmpdir=tmpdir)
        marks.append(("graph", time.perf_counter()))
        state = runner.setup(ctx)
        marks.append(("runner", time.perf_counter()))
        runner.unit(state, {"index": -1, "profiled": False})  # the warm-up
        _sync(device)
        marks.append(("warmup", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        # the seconds of each part of set-up, "start" those before run()
        setup_parts = {name: t - t0 for (name, t), t0 in zip(marks, [t_start] + [t for _, t in marks])}
        cuda = device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        spans = Spans(traffic.get("spans", {}), device) if trace_on else None
        # the traced run profiles units 1..n_traced, past the window's first
        n_traced = int(traffic.get("trace_units", 2)) if trace_on else 0
        units: List[dict] = []
        kept: List[Any] = []
        prof = None
        busy = trace_window = None
        gc_clock = _GcClock()
        with spans if spans is not None else contextlib.nullcontext(), gc_clock:
            t0 = time.perf_counter()
            while len(units) <= n_traced or time.perf_counter() - t0 < seconds:
                i = len(units)
                rec = {"index": i, "profiled": 1 <= i <= n_traced}
                if i == 1 and rec["profiled"]:
                    prof = _profile(device)
                    prof.__enter__()
                    ta = time.perf_counter()
                marks = {k: len(v) for k, v in spans.ms.items()} if spans else {}
                tu = time.perf_counter()
                with (torch.profiler.record_function("unit") if rec["profiled"]
                      else contextlib.nullcontext()):
                    answer = runner.unit(state, rec)
                rec["s"] = time.perf_counter() - tu
                if rec["profiled"]:
                    for k, n in marks.items():  # spans under the profiler are not kept
                        del spans.ms[k][n:]
                units.append(rec)
                if answer is not None:
                    kept.append(answer)
                if i == n_traced and prof is not None:
                    _sync(device)
                    trace_window = time.perf_counter() - ta
                    prof.__exit__(None, None, None)
            _sync(device)
            window_s = time.perf_counter() - t0
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        breakdown = None
        if prof is not None:
            events = prof.events()
            names = dict.fromkeys(["unit", *traffic.get("spans", {})])
            intervals = trace.device_intervals(events, names)
            busy = trace.busy_s(intervals)
            breakdown = {"device_ops": trace.top_device_ops(events, names),
                         "idle_gaps": trace.idle_gaps(events, intervals, names)}
            del prof, events

        # judge after the window, then free the program's state
        judged = list(runner.judge(state, kept))
        extra = runner.numbers(state, units) if hasattr(runner, "numbers") else {}
        runner.release(state)
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    failed = sum(not check.verdict(n, {k: limits[k] for k in n if k in limits})[0]
                 for n in judged)
    attempted = len(units)
    numbers = check.worst(judged + [extra])
    ok, checks = check.verdict(numbers, limits)
    correct = ok and bool(judged) and failed == 0

    record = {
        "setup_s": setup_s, "window_s": window_s, "units": len(units),
        "unit_s": [u["s"] for u in units], "peak_bytes": window_peak if cuda else None,
        "stages": [u["stage_times"] for u in units
                   if "stage_times" in u and not u["profiled"]],
        "spans": spans.ms if spans is not None else {},
        "busy_s": busy if cuda else None, "trace_window_s": trace_window,
        "graph": {"v": n_nodes, "nnz": reference.nnz(ctx.edges, n_nodes)},
        "config": config, "traffic": traffic, "workload": workload,
    }
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = load_file(bdir / "metrics" / f"{m['name']}.py",
                           "benchmark_metric_" + m["name"].replace(".", "_"))
        x = reader.read(record)
        if x is not None:
            metrics[m["name"]] = {"value": float(x), "unit": m["unit"]}

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if trace_on:
        out["device"]["busy_s"] = busy
        out["device"]["window_s"] = trace_window
        if breakdown is not None:
            out["breakdown"] = breakdown
    out["checks"] = checks
    return out, {"unit_s": record["unit_s"], "gc_s": gc_clock.seconds, "setup_parts": setup_parts}

