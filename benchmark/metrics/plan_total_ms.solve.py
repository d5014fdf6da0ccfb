"""Host ms of the plan per solve: the program's ``stage_times["plan"]``,
the span around the call that builds the plan (the stream's host build, its
uploads, the design rule's copy and the layout; the card synchronised at
its end), median over the window's unprofiled solves."""

from statistics import median


def read(rec):
    xs = [s["plan"] for s in rec["stages"] if "plan" in s]
    return median(xs) if xs else None
