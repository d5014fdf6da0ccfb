"""Readings of the numbers compared, over seeds, for setting the limits.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 --modes fast16 [--truncate 15 20 25]

Each reading is one run of the cell through ``harness.run`` with a window
of one unit (after its warm-up), in the precision of ``--modes`` (the
configuration's ``kahan``, or the control: the program's own bf16 path,
``fast16``), judged by the harness's own verdict.  ``--truncate K`` also
reads the configuration's precision with the program's solve cut to K
iterations (``exact_simrank_spmm`` given K in place of the mix's count), a
fault planted in the program.  One JSON line a reading.
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def truncated(k):
    """The program's exact SimRank cut to ``k`` iterations while entered."""
    import graphtpu_torch.simrank.exact as exact

    orig = exact.exact_simrank_spmm

    def cut(g, cfg, *args, **kw):
        return orig(g, dataclasses.replace(cfg, iterations=min(k, cfg.iterations)), *args, **kw)

    exact.exact_simrank_spmm = cut
    try:
        yield
    finally:
        exact.exact_simrank_spmm = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="*", default=["fast16"])
    ap.add_argument("--truncate", type=int, nargs="*", default=[])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    device = torch.device(args.device)
    cases = [(m, None) for m in args.modes] + [(None, k) for k in args.truncate]
    for seed in args.seeds:
        for mode, k in cases:
            t0 = time.perf_counter()
            with truncated(k) if k is not None else contextlib.nullcontext():
                out = harness.run(ROOT, args.workload, seed, 0.0, bool(args.trace), device, t0,
                                  mode=mode)[0]
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "iterations": k, "correct": out["correct"],
                              "checks": out["checks"], "s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
