"""Command-line interface: ``python -m graphtpu_torch simrank ...``.

The flags and defaults of ``graphtpu``'s ``simrank`` subcommand, plus
``--device`` (default ``cuda``; a missing card is an error, never a quiet
move to the CPU) and ``--n-nodes`` (default: the largest id + 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="graphtpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sr = sub.add_parser("simrank", help="exact SimRank -> top-k .sim.txt")
    sr.add_argument("--input", required=True)
    sr.add_argument("--output", required=True)
    sr.add_argument("--c", type=float, default=0.6)
    sr.add_argument("--iterations", type=int, default=3)
    sr.add_argument("--topk", type=int, default=20)
    sr.add_argument("--weighted", action="store_true")
    sr.add_argument("--delimiter", default=None)
    sr.add_argument(
        "--engine", default="dense", choices=["dense", "spmm"],
        help="dense fp32 matmul iterate or streaming sparse products",
    )
    sr.add_argument(
        "--mode", default="kahan", choices=["kahan", "fast", "fast16"],
        help="spmm numerics: compensated f32, plain f32, or bf16 iterates "
             "with f32 accumulation",
    )
    sr.add_argument(
        "--relabel", default="none", choices=["none", "bfs", "rcm", "degree"],
        help="locality relabeling before compute; output ids are mapped back",
    )
    sr.add_argument(
        "--seg", type=int, default=1,
        help="spmm: k-row coalesced segments (pair with --relabel)",
    )
    sr.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sr.add_argument(
        "--n-nodes", type=int, default=None,
        help="node count (default: largest id + 1); extra ids are isolated",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd != "simrank":
        return 1
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.io.simfile import write_topk_files
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank.exact import (
        exact_simrank,
        exact_simrank_spmm,
        resolve_device,
    )

    device = resolve_device(args.device)
    g = read_edgelist_graph(
        args.input, delimiter=args.delimiter, weighted=args.weighted,
        n_nodes=args.n_nodes,
    )
    cfg = SimRankConfig(c=args.c, iterations=args.iterations)
    order = None
    if args.relabel != "none":
        from graphtpu_torch.core.reorder import (
            bfs_order,
            degree_order,
            rcm_order,
            relabel_graph,
        )

        ofn = {"bfs": bfs_order, "rcm": rcm_order, "degree": degree_order}[args.relabel]
        order = np.asarray(ofn(g), np.int64)
        g, inv = relabel_graph(g, order)
    if args.engine == "spmm":
        sim = exact_simrank_spmm(
            g, cfg, weighted=args.weighted,
            spmv_mode="fast" if args.mode == "fast16" else args.mode,
            dtype=torch.bfloat16 if args.mode == "fast16" else torch.float32,
            spmv_seg=args.seg, device=device,
        )
    else:
        sim = exact_simrank(g, cfg, weighted=args.weighted, device=device)
    vals, idx = topk_rows(sim, args.topk)
    del sim
    vals = vals.float().cpu().numpy()
    idx = idx.cpu().numpy()
    if order is not None:
        # row new_i is original order[new_i]; neighbour new_j is order[new_j]
        inv_rows = np.asarray(inv, np.int64)  # inv[old] = new
        vals = vals[inv_rows]
        idx = order[idx[inv_rows]].astype(np.int32)
    write_topk_files(args.output, idx, vals)
    print(f"wrote {args.output}(.sim.txt)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
