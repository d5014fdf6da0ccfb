"""Readings of the numbers compared in a UniWalk cell, for setting its limits.

    python3 benchmark/readings_uniwalk.py --workload urand.uniwalk-solve --seeds 1 2 3 \
        --cases program sample25 sample50 sample75 bf16 bf16_answer drop_tile

Each reading is one run of the cell through ``harness.run`` with a window
of one unit (after its warm-up), judged by the harness's own verdict, with
the program as it is (``program``) or with a control planted in it:
``sample25``, ``sample50``, ``sample75`` (that share of the configuration's
SAMPLE: less work than stated), ``bf16`` (every item's value rounded to
bfloat16), ``bf16_answer`` (the answer's scores rounded to bfloat16) or
``drop_tile`` (one source tile's rows left empty).  One JSON line a reading.
"""

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _replaced(name, make):
    """The program's ``uniwalk.<name>`` replaced by ``make(original)``
    while entered."""
    uw = importlib.import_module("graphtpu_torch.simrank.uniwalk")
    orig = getattr(uw, name)
    setattr(uw, name, make(orig))
    try:
        yield
    finally:
        setattr(uw, name, orig)


def _sample(percent):
    def make(orig):
        def cut(g, cfg, *a, **kw):
            return orig(g, dataclasses.replace(cfg, sample=cfg.sample * percent // 100), *a, **kw)
        return cut
    return lambda: _replaced("uniwalk_simrank", make)


def bf16():
    def make(orig):
        def rounded(*a, **kw):
            return orig(*a, **kw).bfloat16().float()
        return rounded
    return _replaced("_meet_value", make)


def bf16_answer():
    def make(orig):
        def rounded(*a, **kw):
            import torch

            vals, idx = orig(*a, **kw)
            return torch.from_numpy(vals).bfloat16().float().numpy(), idx
        return rounded
    return _replaced("uniwalk_simrank", make)


def drop_tile():
    def make(orig):
        def dropped(g, cfg, *a, **kw):
            vals, idx = orig(g, cfg, *a, **kw)
            lo = cfg.source_tile if len(idx) > cfg.source_tile else 0
            vals[lo:lo + cfg.source_tile] = 0.0
            idx[lo:lo + cfg.source_tile] = -1
            return vals, idx
        return dropped
    return _replaced("uniwalk_simrank", make)


CASES = {"program": contextlib.nullcontext, "sample25": _sample(25), "sample50": _sample(50),
         "sample75": _sample(75), "bf16": bf16, "bf16_answer": bf16_answer,
         "drop_tile": drop_tile}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="urand.uniwalk-solve")
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
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
