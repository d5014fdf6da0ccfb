"""Host-clock wall time of the main path: the CLI run and the SimRank call.

    python graphtpu_torch/bench/wall.py [--runs 3] [--only CASES] [--out wall.json]

Times, on the first CUDA card, ``python -m graphtpu_torch simrank --engine
spmm`` (file in to files out) and one ``exact_simrank_spmm`` call (plan
built, three iterations, result on the card) on the blog-shaped graph in
modes kahan, fast and fast16, and in kahan and fast16 with ``--relabel rcm
--seg 2`` (the call on the RCM-relabelled graph's seg-2 stream), and on
the R-MAT graph in kahan, at 3 iterations and top-20, and the tree
branch's call (``impl="tree"``, f32; the CLI has no tree option) on both
graphs: one warm-up, then the median and every reading of ``--runs`` runs,
and the call's device ms per iteration (its ``stage_times``, CUDA events).
``--only`` takes a comma list of ``graph:mode`` cases.  It uses only entry
points that earlier commits of
graphtpu_torch share, so it runs as a script against whichever package is
first on ``PYTHONPATH``, for example an earlier commit's tree unpacked by
``git archive`` into a git-ignored directory: run parent, change, change,
parent in one session on one card to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import graphtpu_torch
from graphtpu_torch import read_edgelist_graph
from graphtpu_torch.bench.generators import (
    BLOG_NODES,
    RMAT14_NODES,
    blog_shaped_edges,
    rmat14_edges,
)
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.reorder import rcm_order, relabel_graph
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.simrank.exact import exact_simrank_spmm

CASES = (("blog", "kahan"), ("blog", "fast"), ("blog", "fast16"), ("blog", "tree"),
         ("blog", "kahan_seg2_rcm"), ("blog", "fast16_seg2_rcm"), ("rmat", "kahan"),
         ("rmat", "tree"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--only", default=None, help="comma list of graph:mode cases (default: all)")
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    cases = CASES if args.only is None else [tuple(c.split(":")) for c in args.only.split(",")]
    if not torch.cuda.is_available():
        raise RuntimeError("wall needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    pkg = os.path.dirname(os.path.abspath(graphtpu_torch.__file__))
    print(f"card: {card}; package {pkg}", flush=True)
    dev = torch.device("cuda")
    cfg = SimRankConfig(iterations=3)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        graphs = {"blog": (blog_shaped_edges(), BLOG_NODES), "rmat": (rmat14_edges(), RMAT14_NODES)}
        for tag, (edges, n) in graphs.items():
            path = os.path.join(tmp, f"{tag}.txt")
            write_edgelist(path, edges)
            g = read_edgelist_graph(path, n_nodes=n)
            for gtag, mode in cases:
                if gtag != tag:
                    continue
                base, _, seg_tag = mode.partition("_seg")
                seg = 2 if seg_tag else 1
                argv_cli = ["simrank", "--input", path, "--output", os.path.join(tmp, "o.txt"),
                            "--engine", "spmm", "--mode", base, "--iterations", "3",
                            "--topk", "20", "--n-nodes", str(n), "--device", "cuda"]
                run_g = g
                if seg > 1:
                    argv_cli += ["--relabel", "rcm", "--seg", str(seg)]
                    run_g = relabel_graph(g, rcm_order(g))[0]
                kernel = "kahan" if base == "kahan" else "fast"
                dtype = torch.bfloat16 if base == "fast16" else torch.float32

                tree = mode == "tree"

                def call(stages):
                    if tree:
                        sim = exact_simrank_spmm(run_g, cfg, impl="tree", device=dev,
                                                 stage_times=stages)
                    else:
                        sim = exact_simrank_spmm(run_g, cfg, spmv_mode=kernel, dtype=dtype,
                                                 spmv_seg=seg, device=dev, stage_times=stages)
                    torch.cuda.synchronize()
                    del sim

                cli, spmm_call, iteration = [], [], []
                for i in range(args.runs + 1):  # the first run warms up
                    t0 = time.perf_counter()
                    if not tree and cli_main(argv_cli) != 0:
                        raise RuntimeError(f"{tag} {mode}: CLI failed")
                    t1 = time.perf_counter()
                    stages = {}
                    call(stages)
                    t2 = time.perf_counter()
                    if i:
                        cli.append(t1 - t0)
                        spmm_call.append(t2 - t1)
                        iteration.append(sum(stages[k] for k in ("product1", "transpose",
                                                                 "product2")) / cfg.iterations)
                    torch.cuda.empty_cache()
                r = dict(graph=tag, mode=mode,
                         cli_wall_s=None if tree else float(np.median(cli)),
                         spmm_call_wall_s=float(np.median(spmm_call)),
                         iteration_ms=float(np.median(iteration)),
                         cli_runs=None if tree else cli, spmm_call_runs=spmm_call,
                         iteration_runs=iteration)
                rows.append(r)
                print(f"{tag} {mode}: "
                      + ("" if tree else
                         f"CLI {r['cli_wall_s']:.4f} s {[round(t, 4) for t in cli]}, ")
                      + f"spmm call {r['spmm_call_wall_s']:.4f} s "
                      f"{[round(t, 4) for t in spmm_call]} (host clock); an iteration "
                      f"{r['iteration_ms']:.3f} ms {[round(t, 3) for t in iteration]} on the "
                      "card (CUDA events)", flush=True)
    res = dict(card=card, package=pkg, cases=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
