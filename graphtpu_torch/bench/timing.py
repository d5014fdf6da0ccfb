"""Device timing shared by the port's checks and probes."""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

import numpy as np
import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them; raises
    where nvidia-smi does not run."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def stream_csr(plan, weights) -> torch.Tensor:
    """An item stream's P as a [V, V] CSR over ``weights`` (``seg_k`` a
    stream item, as the stream's ``wts``): one entry per sub-row j of item t
    with a nonzero weight, at column ``slots[t] + j`` (rows < V, the pad
    row dropped).  The operand of the ``torch.sparse.mm`` yardstick of
    B1/B2 and X3."""
    v, k = plan.n_nodes, plan.seg_k
    t = plan.slots.numel()
    w = weights.reshape(-1)[: t * k].view(t, k)
    cols = plan.slots.long()[:, None] + torch.arange(k, device=w.device)
    rows = plan.pos.long()[:, None].expand(t, k)
    keep = (rows < v) & (w != 0)
    crow = torch.searchsorted(rows[keep], torch.arange(v + 1, device=w.device))
    return torch.sparse_csr_tensor(crow, cols[keep], w[keep], (v, v))


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


def device_profile(fn) -> Tuple[Optional[float], int]:
    """(ms the card was busy, device intervals: kernels and copies) during
    one call of ``fn``, from the profiler; the ms are None where the
    profiler records no device interval."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ms = busy_ms_of(events)
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    return (ms if ms > 0 else None), n


def busy_ms(fn) -> Optional[float]:
    """ms the card was busy during one call of ``fn`` (the profiler's
    device intervals), or None where the profiler records none."""
    return device_profile(fn)[0]
