"""The card's idle share in a node2vec job, in %: 1 - the card's busy time
in the profiled job (the union of the profiler's device intervals) over
the median seconds of the window's jobs that ran without the profiler, as
``idle_share.topsim`` reads it: the profiler slows the host's launches
(the walks', the set-up's, each step's replay) and so idles the card in
the profiled job itself."""

from statistics import median


def read(rec):
    n = int(rec["traffic"].get("trace_units", 2))
    free = rec["unit_s"][:1] + rec["unit_s"][n + 1:]
    if not rec["busy_s"] or not free:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / n / median(free))
