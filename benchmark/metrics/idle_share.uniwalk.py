"""The device's idle share in a UniWalk solve, in %: 1 - the device's busy
time a profiled solve (the union of the profiler's device intervals over
the profiled units, each unit's share) over the median seconds of the
window's solves that ran without the profiler.  The profiler slows the
host's launches (some 48,000 a solve) and so leaves the device idle in the
profiled window itself; the unprofiled solves show what the program
leaves idle."""

from statistics import median


def read(rec):
    n = int(rec["traffic"].get("trace_units", 2))
    free = rec["unit_s"][:1] + rec["unit_s"][n + 1:]
    if not rec["busy_s"] or not free:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / n / median(free))
