"""Device ms a TopSim solve spends in the program's stage ``items``: the
sum over its source tiles of ``stage_times["items"]`` (CUDA events), median
over the window's unprofiled traced solves."""

from statistics import median


def read(rec):
    xs = [s["items"] for s in rec["stages"] if "items" in s]
    return median(xs) if xs else None
