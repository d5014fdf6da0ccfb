"""The program's ``stage_times``, counted: a traced run passes one to
``exact_simrank_spmm`` and reads how many product stages the call ran."""

from __future__ import annotations


class Counted(dict):
    """``stage_times`` that counts the times each stage is added to."""

    def __init__(self):
        super().__init__()
        self.adds = {}

    def __setitem__(self, key, value):
        self.adds[key] = self.adds.get(key, 0) + 1
        super().__setitem__(key, value)


def keep_counts(rec, times) -> None:
    """Record a unit's counted stages in its record."""
    rec["stage_times"] = dict(times)
    rec["stage_adds"] = dict(times.adds)


def iterations_short(units, iterations: int) -> dict:
    """``iterations_short``: the most by which a traced call's product-1
    stages fall short of the mix's iterations (only where counted)."""
    counted = [u["stage_adds"].get("product1", 0) for u in units if "stage_adds" in u]
    if not counted:
        return {}
    return {"iterations_short": float(iterations - min(counted))}
