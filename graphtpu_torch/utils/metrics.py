"""Structured step metrics and a profiler hook (counterpart of
``graphtpu/utils/metrics.py``).

The reference mines Giraph logs for per-superstep wall times
(``utils/SuperstepTimes.java:14-45``, ``utils/LogProcess.java:19-45``);
here every window or loop records its wall time directly, and
``trace_profile`` wraps a region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


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


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), written to ``logdir/trace.json``; no-op without a logdir."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
