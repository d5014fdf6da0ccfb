"""Kernels B1/B2's share of their least time: a solve's 2·iterations
products counted from the graph (``benchmark.roofline.products_ms``: the
configuration's precision, C = V, the first product of every iteration
after the first pinned) over the program's ``stage_times`` product1 +
product2, in %; median over the window's solves."""

from statistics import median

from benchmark.precision import ITEMSIZE, MODES
from benchmark.roofline import products_ms


def read(rec):
    spmv_mode, dtype = MODES[rec["config"]["simrank"]["mode"]]
    g = rec["graph"]
    least = products_ms(g["nnz"], g["v"], int(rec["traffic"]["iterations"]), ITEMSIZE[dtype],
                        spmv_mode == "kahan")
    xs = [s["product1"] + s["product2"] for s in rec["stages"]
          if {"product1", "product2"} <= s.keys()]
    if not xs or median(xs) <= 0:
        return None
    return 100.0 * least / median(xs)
