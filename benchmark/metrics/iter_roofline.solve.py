"""The whole iteration's share of the chip: the least time of S' = C·P·S·Pᵀ
(``benchmark.roofline.iteration_ms``, counted from the graph) over the
measured iteration (``iter_ms.solve``'s reading), in %."""

from statistics import median

from benchmark.roofline import iteration_ms


def read(rec):
    it = int(rec["traffic"]["iterations"])
    xs = [(s["product1"] + s["transpose"] + s["product2"]) / it for s in rec["stages"]
          if {"product1", "transpose", "product2"} <= s.keys()]
    if not xs or median(xs) <= 0:
        return None
    return 100.0 * iteration_ms(rec["graph"]["nnz"], rec["graph"]["v"]) / median(xs)
