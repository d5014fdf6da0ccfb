"""Readings of the numbers compared in a TopSim cell, for setting its limits.

    python3 benchmark/readings_topsim.py --workload urand.topsim-solve --seeds 1 2 3 \
        --cases program sample25 w_cut sampled bf16_mass drop_tile

Each reading is one run of the cell through ``harness.run`` with a window
of one unit (after its warm-up), judged by the harness's own verdict, with
the program as it is (``program``) or with a control planted in it:
``sample25`` (a quarter of the configuration's SAMPLE: less work than
stated), ``w_cut`` (the frontier's W cut to SAMPLE, so that mass is
dropped), ``sampled`` (every parent draws ceil(s) neighbours: the split
rule never taken), ``bf16_mass`` (every frontier's mass rounded to
bfloat16) or ``drop_tile`` (one source tile's rows left empty).  The
controls act on the solves and on the runner's tile made anew alike.  One
JSON line a reading.
"""

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _topsim():
    return importlib.import_module("graphtpu_torch.simrank.topsim")


@contextlib.contextmanager
def _replaced(name, make):
    """The program's ``topsim.<name>`` replaced by ``make(original)`` while
    entered."""
    ts = _topsim()
    orig = getattr(ts, name)
    setattr(ts, name, make(orig))
    try:
        yield
    finally:
        setattr(ts, name, orig)


def sample25():
    def make(orig):
        def cut(g, cfg, *a, **kw):
            return orig(g, dataclasses.replace(cfg, sample=cfg.sample / 4), *a, **kw)
        return cut
    return _replaced("topsim_simrank", make)


def w_cut():
    return _replaced("frontier_capacity", lambda orig: lambda g, cfg: math.ceil(cfg.sample))


def sampled():
    """The expansion sees every degree raised past any mass, so no parent
    splits; its draws still read the graph's own rows."""
    ts = _topsim()

    def make(orig):
        def never_split(g, paths, mass, depth, key, enumerate_all=False):
            draw = ts.neighbor_at
            ts.neighbor_at = lambda _, cur, u: draw(g, cur, u)
            try:
                return orig(dataclasses.replace(g, deg=g.deg + (1 << 30)), paths, mass, depth,
                            key, enumerate_all)
            finally:
                ts.neighbor_at = draw
        return never_split
    return _replaced("_expand_frontier", make)


def bf16_mass():
    def make(orig):
        def rounded(*a, **kw):
            paths, mass, dropped = orig(*a, **kw)
            return paths, mass.bfloat16().float(), dropped
        return rounded
    return _replaced("_expand_frontier", make)


def drop_tile():
    def make(orig):
        def dropped(g, cfg, *a, **kw):
            vals, idx = orig(g, cfg, *a, **kw)
            lo = cfg.source_tile if len(idx) > cfg.source_tile else 0
            vals[lo:lo + cfg.source_tile] = 0.0
            idx[lo:lo + cfg.source_tile] = -1
            return vals, idx
        return dropped
    return _replaced("topsim_simrank", make)


CASES = {"program": contextlib.nullcontext, "sample25": sample25, "w_cut": w_cut,
         "sampled": sampled, "bf16_mass": bf16_mass, "drop_tile": drop_tile}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="urand.topsim-solve")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES), default=sorted(CASES))
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    device = torch.device(args.device)
    for seed in args.seeds:
        for case in args.cases:
            t0 = time.perf_counter()
            with CASES[case]():
                out = harness.run(ROOT, args.workload, seed, 0.0, bool(args.trace), device, t0)[0]
            print(json.dumps({"workload": args.workload, "seed": seed, "case": case,
                              "correct": out["correct"], "checks": out["checks"],
                              "metrics": out["metrics"], "s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
