"""Device ms a TopSim solve spends in the program's stage ``reduce``: the
sum over its source tiles of ``stage_times["reduce"]`` (CUDA events), median
over the window's unprofiled traced solves."""

from statistics import median


def read(rec):
    xs = [s["reduce"] for s in rec["stages"] if "reduce" in s]
    return median(xs) if xs else None
