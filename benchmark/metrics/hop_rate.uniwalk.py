"""Walk hops a second, in millions: the hops a UniWalk solve counted (the
program's ``UNIWALK_COUNTS["hops"]``, taken by the runner) over its
``walks`` stage, median over the window's unprofiled traced solves."""

from statistics import median


def read(rec):
    xs = [s["hops"] / s["walks"] / 1e3 for s in rec["stages"]
          if "hops" in s and s.get("walks", 0) > 0]
    return median(xs) if xs else None
