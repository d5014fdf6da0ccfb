"""Host ms of the plan's kernel layout per solve: the program's
``stage_times["layout_host"]``, median over the window's solves.  Where
the kernels run row tiles the program builds no layout and reports 0:
nothing to read."""

from statistics import median


def read(rec):
    xs = [s["layout_host"] for s in rec["stages"] if "layout_host" in s]
    return median(xs) if xs and max(xs) > 0 else None
