"""Host ms of the benchmark's span ``topk`` around the program's call
(named in the traffic file), median over the window's units."""

from statistics import median


def read(rec):
    xs = rec["spans"].get("topk")
    return median(xs) if xs else None
