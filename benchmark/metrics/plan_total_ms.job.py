"""Host ms of the plan per CLI job: the program's ``stage_times["plan"]``
in the job's call of ``exact_simrank_spmm`` (handed by the CLI runner),
the span around the call that builds the plan, median over the window's
unprofiled jobs."""

from statistics import median


def read(rec):
    xs = [s["plan"] for s in rec["stages"] if "plan" in s]
    return median(xs) if xs else None
