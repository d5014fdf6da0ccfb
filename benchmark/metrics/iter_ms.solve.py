"""Device ms of one SimRank iteration: the program's ``stage_times``
product1 + transpose + product2 (CUDA events) over the iterations, median
over the window's solves."""

from statistics import median


def read(rec):
    it = int(rec["traffic"]["iterations"])
    xs = [(s["product1"] + s["transpose"] + s["product2"]) / it for s in rec["stages"]
          if {"product1", "transpose", "product2"} <= s.keys()]
    return median(xs) if xs else None
