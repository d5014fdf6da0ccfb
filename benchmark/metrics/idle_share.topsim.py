"""The device's idle share in a TopSim solve, in %: 1 - the device's busy
time a profiled solve (the union of the profiler's device intervals over
the profiled units, each unit's share) over the median seconds of the
window's solves that ran without the profiler, as ``idle_share.uniwalk``
reads it: the profiler slows the host's launches and so idles the device
in the profiled window itself."""

from statistics import median


def read(rec):
    n = int(rec["traffic"].get("trace_units", 2))
    free = rec["unit_s"][:1] + rec["unit_s"][n + 1:]
    if not rec["busy_s"] or not free:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / n / median(free))
