"""Command-line interface: ``python -m graphtpu_torch {simrank,node2vec} ...``.

The flags and defaults of ``graphtpu``'s ``simrank`` and ``node2vec``
subcommands, plus ``--device`` (default ``cuda``; a missing card is an
error, never a quiet move to the CPU) and, for ``simrank``, ``--n-nodes``
(default: the largest id + 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="graphtpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    n2v = sub.add_parser("node2vec", help="node2vec walks + SGNS -> .emb")
    n2v.add_argument("--input", required=True)
    n2v.add_argument("--output", required=True)
    n2v.add_argument("--dimensions", type=int, default=128)
    n2v.add_argument("--walk-length", type=int, default=80)
    n2v.add_argument("--num-walks", type=int, default=10)
    n2v.add_argument("--window-size", type=int, default=10)
    n2v.add_argument("--iter", type=int, default=10)
    n2v.add_argument("--p", type=float, default=1.0)
    n2v.add_argument("--q", type=float, default=1.0)
    n2v.add_argument("--weighted", action="store_true")
    n2v.add_argument("--directed", action="store_true")
    n2v.add_argument("--delimiter", default=None)
    n2v.add_argument("--seed", type=int, default=0)
    n2v.add_argument("--subsample", type=float, default=1e-3)
    # the reference sweeps the full p x q cross product
    # (node2vec/src/main.py:117-124), one .emb per setting; --grid-diag
    # keeps p == q only
    n2v.add_argument("--grid", default=None)
    n2v.add_argument("--grid-diag", action="store_true")
    n2v.add_argument("--device", default="cuda", help="torch device (default cuda)")

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
    if args.cmd == "node2vec":
        return node2vec_main(args)
    return simrank_main(args)


def node2vec_main(args) -> int:
    from graphtpu_torch.core.config import SGNSConfig, WalkConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.pipelines import node2vec_pipeline

    device = resolve_device(args.device)
    g = read_edgelist_graph(
        args.input, delimiter=args.delimiter, weighted=args.weighted,
        directed=args.directed,
    )
    if args.directed:
        g = g.out
    if args.grid:
        vals = [float(x) for x in args.grid.split(",")]
        pqs = [(x, x) for x in vals] if args.grid_diag else [(a, b) for a in vals for b in vals]
    else:
        pqs = [(args.p, args.q)]
    for p, q in pqs:
        out = args.output if len(pqs) == 1 else f"{args.output}.p{p:g}_q{q:g}.emb"
        times = {}
        node2vec_pipeline(
            g,
            walk_cfg=WalkConfig(num_walks=args.num_walks, walk_length=args.walk_length, p=p, q=q),
            sgns_cfg=SGNSConfig(dim=args.dimensions, window=args.window_size,
                                epochs=args.iter, subsample=args.subsample, seed=args.seed),
            seed=args.seed, output=out, device=device, stage_times=times,
        )
        print(f"wrote {out} ("
              + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()) + ")")
    return 0


def simrank_main(args) -> int:
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.io.simfile import write_topk_files
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

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
