"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs CUDA and as many cards as the cell asks for; exits non-zero with
no result otherwise.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared beside its limit); the last lines of standard error repeat the
checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else repr(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    _, cell, _, _ = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, info = harness.run(ROOT, args.workload, args.seed % (1 << 63), args.seconds,
                            bool(args.trace), torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules the benchmark may not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    unit_s = info["unit_s"]
    q = statistics.quantiles(unit_s, n=10) if len(unit_s) > 1 else unit_s * 9
    print(json.dumps({"units": len(unit_s), "unit_s_p10": q[0], "unit_s_p50": q[4],
                      "unit_s_p90": q[8], "gc_s": info["gc_s"],
                      "setup_parts": info["setup_parts"], "unit_s": unit_s}))
    for name, c in out["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
