"""Host ms of the benchmark's span ``read`` around the program's call
(named in the traffic file), median over the window's units."""

from statistics import median


def read(rec):
    xs = rec["spans"].get("read")
    return median(xs) if xs else None
