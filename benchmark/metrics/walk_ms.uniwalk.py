"""Device ms a UniWalk solve spends in the program's stage ``walks``: the
sum over its source tiles of ``stage_times["walks"]`` (CUDA events), median
over the window's unprofiled traced solves."""

from statistics import median


def read(rec):
    xs = [s["walks"] for s in rec["stages"] if "walks" in s]
    return median(xs) if xs else None
