"""Host ms of the benchmark's span ``simrank`` around the program's call
(named in the traffic file), median over the window's units."""

from statistics import median


def read(rec):
    xs = rec["spans"].get("simrank")
    return median(xs) if xs else None
