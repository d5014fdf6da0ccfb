"""The SGNS steps' share of the card's bandwidth, in %: the least time of
the bytes the job's steps must move (``benchmark/roofline_node2vec.py``,
from ``SGNS_COUNTS``' steps, centers and negatives and the job's node
count) over the program's ``sgns`` span, median over the window's
unprofiled traced jobs."""

from statistics import median

from benchmark.roofline_node2vec import steps_ms


def read(rec):
    cfg = rec["config"]["node2vec"]
    xs = [100.0 * steps_ms(s["n_steps"], s["n_centers"], s["n_negatives"], int(s["n_nodes"]),
                           int(cfg["dimensions"]), int(cfg["window"])) / s["sgns"]
          for s in rec["stages"]
          if {"n_steps", "n_centers", "n_negatives", "n_nodes", "sgns"} <= s.keys()
          and s["sgns"] > 0]
    return median(xs) if xs else None
