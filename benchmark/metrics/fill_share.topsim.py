"""The share of the frontier's slots that hold a live path, in %: the live
slots over the slots a TopSim solve's expansions filled (the program's
``TOPSIM_COUNTS``, taken by the runner), median over the window's
unprofiled traced solves.  The rest of each expansion's work is on empty
slots."""

from statistics import median


def read(rec):
    xs = [100.0 * s["live"] / s["slots"] for s in rec["stages"]
          if "live" in s and s.get("slots", 0) > 0]
    return median(xs) if xs else None
