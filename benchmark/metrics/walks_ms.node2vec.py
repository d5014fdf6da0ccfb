"""Ms of the program's stage ``walks`` in a node2vec job
(``node2vec_pipeline``'s ``stage_times``: a ``StageClock`` span, the host
clock with the card synchronised at its end), median over the window's
unprofiled traced jobs."""

from statistics import median


def read(rec):
    xs = [s["walks"] for s in rec["stages"] if "walks" in s]
    return median(xs) if xs else None
