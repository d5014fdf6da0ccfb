"""Device ms a TopSim solve spends in the program's stage ``expand``: the
sum over its source tiles of ``stage_times["expand"]`` (CUDA events), median
over the window's unprofiled traced solves."""

from statistics import median


def read(rec):
    xs = [s["expand"] for s in rec["stages"] if "expand" in s]
    return median(xs) if xs else None
