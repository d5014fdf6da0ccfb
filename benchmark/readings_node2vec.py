"""Readings of the numbers compared in the node2vec cell, for setting its
limits.

    python3 benchmark/readings_node2vec.py --workload kron14.node2vec-job --seeds 1 2 3 \
        --cases program pq1 bf16_grads tenth

Each reading is one run of the cell through ``harness.run`` with a window
of one job (after its warm-up), judged by the harness's own verdict, with
the program as it is (``program``) or with a control planted in it:
``pq1`` (the walks at p = q = 1, first-order: the bias rule not taken),
``bf16_grads`` (every SGNS step's summed gradients rounded to bfloat16
before the update) or ``tenth`` (SGNS trained on the first tenth of the
walks, one pass over the nodes: a tenth of the epoch's steps).  One JSON
line a reading.
"""

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _replaced(module, name, make):
    """The program's ``<module>.<name>`` replaced by ``make(original)``
    while entered."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def pq1():
    def make(orig):
        def first_order(*a, p=1.0, q=1.0, **kw):
            return orig(*a, p=1.0, q=1.0, **kw)
        return first_order
    return _replaced("graphtpu_torch.pipelines", "simulate_walks", make)


def bf16_grads():
    def make(orig):
        def rounded(*a, **kw):
            (g0, g1), counts = orig(*a, **kw)
            return (g0.bfloat16().float(), g1.bfloat16().float()), counts
        return rounded
    return _replaced("graphtpu_torch.models.sgns", "sgns_manual_grads", make)


def tenth():
    def make(orig):
        def cut(walks, *a, **kw):
            return orig(walks[: walks.shape[0] // 10], *a, **kw)
        return cut
    return _replaced("graphtpu_torch.pipelines", "train_sgns", make)


CASES = {"program": contextlib.nullcontext, "pq1": pq1, "bf16_grads": bf16_grads,
         "tenth": tenth}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="kron14.node2vec-job")
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
