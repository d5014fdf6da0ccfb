"""Device timing shared by the port's checks and probes."""

from __future__ import annotations

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
