"""Reading a ``torch.profiler`` trace of part of the window.

``busy_s`` is the union of the profiler's device intervals (kernels and
copies), as ``graphtpu_torch.bench.timing.busy_ms_of`` takes it; the
breakdown names the device operations that took most time and the longest
idle gaps by the host span that was open across them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Interval = Tuple[float, float]
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


def _merged(spans: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _on_device(e, spans) -> bool:
    """A device operation (kernel, copy, set), not the device-side copy of a
    host span (a ``record_function`` range, which also covers idle time)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA and e.name not in spans
            and not getattr(e, "is_user_annotation", False))


def device_intervals(events, spans) -> List[Interval]:
    """The profile's device intervals in microseconds, merged."""
    return _merged([(e.time_range.start, e.time_range.end) for e in events
                    if _on_device(e, spans)])


def busy_s(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals) / 1e6


def top_device_ops(events, spans, n: int = 10) -> List[list]:
    """[name, seconds] of the ``n`` device operations (kernels, copies)
    with the most time, summed by name."""
    tot: Dict[str, float] = {}
    for e in events:
        if _on_device(e, spans):
            tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    rows = sorted(tot.items(), key=lambda r: -r[1])[:n]
    return [[k[:NAME_CHARS], us / 1e6] for k, us in rows]


def idle_gaps(events, intervals: List[Interval], spans: Dict[str, None],
              n: int = 10) -> List[list]:
    """[host span, seconds] of the ``n`` longest gaps between device
    intervals (from the first host span's start to the last one's end),
    each named by the innermost of ``spans`` open at its middle."""
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name in spans]
    if not host:
        return []
    lo = min(h[0] for h in host)
    hi = max(h[1] for h in host)
    gaps, t = [], lo
    for a, b in intervals:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "harness"
        out.append([name, (b - a) / 1e6])
    return out
