"""Device ms of one SimRank iteration's transpose: the program's
``stage_times`` "transpose" (CUDA events) over the iterations, median over
the window's solves."""

from statistics import median


def read(rec):
    it = int(rec["traffic"]["iterations"])
    xs = [s["transpose"] / it for s in rec["stages"] if "transpose" in s]
    return median(xs) if xs else None
