"""Structured step metrics, the stage clock and a profiler hook
(counterpart of ``graphtpu/utils/metrics.py``).

The reference mines Giraph logs for per-superstep wall times
(``utils/SuperstepTimes.java:14-45``, ``utils/LogProcess.java:19-45``);
here every window or loop records its wall time directly,
:class:`StageClock` times a call's named stages, and ``trace_profile``
wraps a region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class StepMetrics:
    """Per-step records: the SuperstepTimes/LogProcess replacement."""

    steps: List[Dict] = field(default_factory=list)

    @contextlib.contextmanager
    def step(self, name: str, **extra):
        t0 = time.time()
        rec = {"step": name, **extra}
        try:
            yield rec
        finally:
            rec["seconds"] = time.time() - t0
            self.steps.append(rec)

    def record(self, name: str, seconds: float, **extra) -> None:
        self.steps.append({"step": name, "seconds": seconds, **extra})

    def total_seconds(self) -> float:
        return sum(s.get("seconds", 0.0) for s in self.steps)

    def bucket_histogram(self, bucket: float = 1.0) -> Dict[int, int]:
        """Wall-time histogram, the SuperstepTimes bucket view."""
        out: Dict[int, int] = {}
        for s in self.steps:
            b = int(s.get("seconds", 0.0) / bucket)
            out[b] = out.get(b, 0) + 1
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.steps:
                f.write(json.dumps(s) + "\n")


class StageClock:
    """Adds the ms of named stages to ``times[name]`` (a dict, or None for
    no timing).

    :meth:`stage` times one call: on a CUDA device by two CUDA events, read
    once in :meth:`close`; elsewhere by the host clock.  With ``sync`` it
    takes the host clock between two synchronises of a CUDA device
    instead, so a stage's time is its whole cost: a product's kernels, or
    a collective with gloo's staging through host memory.  :meth:`span`
    times a block of host work by the host clock, a CUDA device
    synchronised at its end (and, with ``sync``, at its start).

    Each stage or span adds to ``times[name]`` by an assignment of its own,
    so a caller's dict may count the adds.  Where the profiler records, each
    also opens ``torch.profiler.record_function(name)``: the spans share the
    device trace's clock.  With ``times`` None a stage only calls its
    function: no event, no synchronise, no range.
    """

    def __init__(self, times: Optional[dict], device, sync: bool = False):
        self.times = times
        self.cuda = torch.device(device).type == "cuda"
        self.sync = self.cuda and sync  # else a stage on a card is timed by CUDA events
        self.marks: List[tuple] = []

    def _range(self, name: str):
        if torch.autograd._profiler_enabled():
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _add(self, name: str, t0: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)

    def stage(self, name: str, fn, *args, **kw):
        if self.times is None:
            return fn(*args, **kw)
        with self._range(name):
            if self.cuda and not self.sync:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kw)
                b.record()
                self.marks.append((name, a, b))
                return out
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self._add(name, t0)
            return out

    @contextlib.contextmanager
    def span(self, name: str):
        if self.times is None:
            yield
            return
        with self._range(name):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            self._add(name, t0)

    def close(self) -> None:
        """Add the stages timed by CUDA events (one synchronise)."""
        if not self.marks:
            return
        torch.cuda.synchronize()
        for name, a, b in self.marks:
            self.times[name] = self.times.get(name, 0.0) + a.elapsed_time(b)
        self.marks.clear()


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), written to ``logdir/trace.json``; no-op without a logdir."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
