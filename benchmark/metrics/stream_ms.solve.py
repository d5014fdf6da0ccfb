"""Host ms of the item stream's numpy build per solve, before its
uploads: the program's ``stage_times["stream_host"]``, a part of its
``plan``, median over the window's unprofiled solves."""

from statistics import median


def read(rec):
    xs = [s["stream_host"] for s in rec["stages"] if "stream_host" in s]
    return median(xs) if xs else None
