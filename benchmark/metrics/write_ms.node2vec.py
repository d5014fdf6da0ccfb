"""Ms of the program's stage ``write`` in a node2vec job
(``node2vec_pipeline``'s ``stage_times``: a ``StageClock`` span, the host
clock with the card synchronised at its end), median over the window's
unprofiled traced jobs."""

from statistics import median


def read(rec):
    xs = [s["write"] for s in rec["stages"] if "write" in s]
    return median(xs) if xs else None
