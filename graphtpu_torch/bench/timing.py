"""Device timing shared by the port's checks and probes."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def cuda_ms(fn, warmup: int = 2, runs: int = 9) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def busy_ms_of(events) -> float:
    """ms covered by the union of a profile's device intervals (kernels,
    copies): the time the card was busy."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo = total + hi - lo, a
        hi = max(hi, b)
    return (total + hi - lo) / 1e3


def busy_ms(fn) -> Optional[float]:
    """ms the card was busy during one call of ``fn`` (the profiler's
    device intervals), or None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = busy_ms_of(prof.events())
    return ms if ms > 0 else None
