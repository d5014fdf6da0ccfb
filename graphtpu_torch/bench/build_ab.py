"""The kernels' build: one nvcc over every source against one nvcc per source.

    python -m graphtpu_torch.bench.build_ab [--out build_ab.json]

Compiles the same ``graphtpu_torch/kernels/csrc/*.cu`` with the same flags
into a shared library, in turns: one ``nvcc -shared`` over all sources, then
``kernels/_build.py``'s build (one ``nvcc -c`` per source, all started
together, then one link) twice, then the single nvcc again, each into a
fresh temporary directory, and prints the wall seconds of each build and
the host's CPU count.  It needs nvcc, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from graphtpu_torch.kernels import _build


def single_nvcc(sources, out: str) -> None:
    """One ``nvcc -shared`` over all ``sources`` into ``out``."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", out, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")


def timed_build(build, sources) -> float:
    """Wall seconds of ``build(sources, out)`` into a fresh directory."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        build(sources, os.path.join(tmp, "lib.so"))
        return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    sources = _build._sources()
    res = {"sources": [s.name for s in sources], "cpus": os.cpu_count(),
           "single_s": [], "per_source_s": []}
    for key, build in (("single_s", single_nvcc), ("per_source_s", _build.compile_library),
                       ("per_source_s", _build.compile_library), ("single_s", single_nvcc)):
        res[key].append(timed_build(build, sources))
        print(f"{key[:-2]}: {res[key][-1]:.2f} s", flush=True)
    print(f"{len(sources)} sources, {res['cpus']} CPUs: one nvcc "
          + "/".join(f"{t:.2f}" for t in res["single_s"]) + " s, one nvcc per source "
          + "/".join(f"{t:.2f}" for t in res["per_source_s"]) + " s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
