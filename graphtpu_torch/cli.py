"""Command-line interface: ``python -m graphtpu_torch
{simrank,node2vec,uniwalk,topsim,sweep,deepsim,sdne,le,generate} ...``.

The flags and defaults of ``graphtpu``'s subcommands of the same names,
plus ``--device`` (default ``cuda``; a missing card is an error, never a
quiet move to the CPU) on all but ``generate``; ``simrank`` adds
``--n-nodes`` (default: the largest id + 1) and
``uniwalk``/``topsim``/``sweep``/``deepsim`` add ``--seed`` (the random
streams' key, default 0).  ``node2vec``, ``uniwalk``, ``topsim``,
``deepsim``, ``sdne``, ``le`` and ``simrank`` print their wall time split
into stages; ``simrank --engine spmm`` also prints its hand kernels'
launches, and ``simrank --profile DIR`` and ``node2vec --profile DIR``
write a ``torch.profiler`` trace of the job, its stages and the card's
kernels on one timeline, to ``DIR/trace.json``.
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
    n2v.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of the job to DIR/trace.json",
    )

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
    sr.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of the job to DIR/trace.json",
    )

    uw = sub.add_parser("uniwalk", help="single-walk MC SimRank")
    uw.add_argument("--input", required=True)
    uw.add_argument("--output", required=True)
    uw.add_argument("--sample", type=int, default=10000)
    uw.add_argument("--step", type=int, default=5)
    uw.add_argument("--topk", type=int, default=20)
    uw.add_argument("--delimiter", default=None)

    ts = sub.add_parser("topsim", help="TopSim deterministic spreading")
    ts.add_argument("--input", required=True)
    ts.add_argument("--output", required=True)
    ts.add_argument("--sample", type=float, default=10000.0)
    ts.add_argument("--step", type=int, default=3)
    ts.add_argument("--topk", type=int, default=20)
    ts.add_argument("--delimiter", default=None)
    ts.add_argument(
        "--engine", default="sample", choices=["sample", "enumerate"],
        help="budget-splitting (TopSim_singleSample) or full path "
             "enumeration (TopSim_Enumerate.java:101-129; exponential)",
    )
    ts.add_argument(
        "--frontier-capacity", type=int, default=0,
        help="walker slots per source (0 = auto bound)",
    )

    sw = sub.add_parser("sweep", help="gold-standard precision sweep")
    sw.add_argument("--input", required=True)
    sw.add_argument("--log", required=True)
    sw.add_argument("--algorithm", choices=["uniwalk", "topsim"], default="uniwalk")
    sw.add_argument("--samples", type=int, nargs="+", default=None)
    sw.add_argument("--delimiter", default=None)

    ds = sub.add_parser("deepsim", help="DeepSim AE over .sim.txt targets")
    ds.add_argument("--input", required=True)
    ds.add_argument("--simrank-path", required=True)
    ds.add_argument("--emb-output", required=True)
    ds.add_argument("--dimensions", type=int, default=128)
    ds.add_argument("--window-size", type=int, default=10)
    ds.add_argument("--vertex-num", type=int, default=0,
                    help="node count (default: the largest id + 1)")
    ds.add_argument("--steps", type=int, default=50000)
    ds.add_argument("--walks-cache", default=None)
    ds.add_argument("--delimiter", default=None)
    for sp in (uw, ts, sw, ds):
        sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
        sp.add_argument("--seed", type=int, default=0, help="random streams' key")

    gen = sub.add_parser("generate", help="synthetic graph -> edge list")
    gen.add_argument("--output", required=True)
    gen.add_argument("--kind", choices=["uniform", "bipartite", "directed", "rmat", "massive"],
                     default="uniform")
    gen.add_argument("--nodes", type=int, default=10000, help="V (left side for bipartite)")
    gen.add_argument("--right", type=int, default=0, help="right-side V for bipartite/massive")
    gen.add_argument("--avg-degree", type=int, default=10)
    gen.add_argument("--scale", type=int, default=14, help="rmat: V = 2^scale")
    gen.add_argument("--edges", type=int, default=0, help="rmat: edge count")
    gen.add_argument("--seed", type=int, default=0)

    sd = sub.add_parser("sdne", help="SDNE sparse autoencoder -> embeddings")
    sd.add_argument("--input", required=True,
                    help="edge list; rows of the adjacency are the AE inputs")
    sd.add_argument("--output", required=True, help=".emb output")
    sd.add_argument("--steps", type=int, default=2000)
    sd.add_argument("--hidden", type=int, nargs="+", default=None,
                    help="encoder widths, e.g. 400 100 (reference MNIST net)")
    sd.add_argument("--delimiter", default=None)
    sd.add_argument("--device", default="cuda", help="torch device (default cuda)")

    le = sub.add_parser("le", help="Laplacian Eigenmaps embedding")
    le.add_argument("--input", default=None,
                    help=".sim.txt top-k file (simRank.py flow); omit for the swiss-roll demo")
    le.add_argument("--output", required=True, help=".npy 2-d embedding (and .png if --plot)")
    le.add_argument("--nodes", type=int, default=0)
    le.add_argument("--plot", action="store_true", help="also write a PNG (needs matplotlib)")
    le.add_argument("--k", type=int, default=10)
    le.add_argument("--t", type=float, default=15.0)
    le.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"node2vec": node2vec_main, "simrank": simrank_main, "uniwalk": mc_main,
            "topsim": mc_main, "sweep": sweep_main, "deepsim": deepsim_main,
            "generate": generate_main, "sdne": sdne_main, "le": le_main}[args.cmd](args)


def _stages(times: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in times.items())


def node2vec_main(args) -> int:
    """Prints each embedding's stages (``StageClock`` spans, the card
    synchronised at each one's end): ``read`` (on the first line only:
    the graph is read once), then the pipeline's ``walks``, ``sgns`` and
    ``write``."""
    from graphtpu_torch.core.config import SGNSConfig, WalkConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.pipelines import node2vec_pipeline
    from graphtpu_torch.utils.metrics import StageClock, trace_profile

    device = resolve_device(args.device)
    times = {}
    with trace_profile(args.profile):
        with StageClock(times, device).span("read"):
            g = read_edgelist_graph(
                args.input, delimiter=args.delimiter, weighted=args.weighted,
                directed=args.directed,
            )
            if args.directed:
                g = g.out
        if args.grid:
            vals = [float(x) for x in args.grid.split(",")]
            pqs = ([(x, x) for x in vals] if args.grid_diag
                   else [(a, b) for a in vals for b in vals])
        else:
            pqs = [(args.p, args.q)]
        for p, q in pqs:
            out = args.output if len(pqs) == 1 else f"{args.output}.p{p:g}_q{q:g}.emb"
            node2vec_pipeline(
                g,
                walk_cfg=WalkConfig(num_walks=args.num_walks, walk_length=args.walk_length,
                                    p=p, q=q),
                sgns_cfg=SGNSConfig(dim=args.dimensions, window=args.window_size,
                                    epochs=args.iter, subsample=args.subsample, seed=args.seed),
                seed=args.seed, output=out, device=device, stage_times=times,
            )
            print(f"wrote {out} ({_stages({k: ms / 1e3 for k, ms in times.items()})})")
            times = {}
    return 0


def simrank_main(args) -> int:
    """Prints the job's stages (``StageClock``): ``read``, ``relabel``
    (where asked: the graph, then the rows and ids back), ``fetch`` (the
    top-k to the host) and ``write`` on the host clock, the card
    synchronised at each one's end; ``simrank`` and ``topk`` by CUDA events
    on a card; then the rows the writer formatted by each path
    (``simfile.WRITE_ROWS``).  The four calls are module attributes looked
    up when the job runs."""
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.io.simfile import WRITE_ROWS, write_topk_files
    from graphtpu_torch.kernels.spmm import SPMV_LAUNCHES
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm
    from graphtpu_torch.utils.metrics import StageClock, trace_profile

    device = resolve_device(args.device)
    launched, written = dict(SPMV_LAUNCHES), dict(WRITE_ROWS)
    times = {}
    clock = StageClock(times, device)
    with trace_profile(args.profile):
        with clock.span("read"):
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
            with clock.span("relabel"):
                order = np.asarray(ofn(g), np.int64)
                g, inv = relabel_graph(g, order)
        if args.engine == "spmm":
            sim = clock.stage(
                "simrank", exact_simrank_spmm, g, cfg, weighted=args.weighted,
                spmv_mode="fast" if args.mode == "fast16" else args.mode,
                dtype=torch.bfloat16 if args.mode == "fast16" else torch.float32,
                spmv_seg=args.seg, device=device,
            )
        else:
            sim = clock.stage("simrank", exact_simrank, g, cfg, weighted=args.weighted,
                              device=device)
        vals, idx = clock.stage("topk", topk_rows, sim, args.topk)
        del sim
        clock.close()
        with clock.span("fetch"):
            vals = vals.float().cpu().numpy()
            idx = idx.cpu().numpy()
        if order is not None:
            with clock.span("relabel"):
                # row new_i is original order[new_i]; neighbour new_j is order[new_j]
                inv_rows = np.asarray(inv, np.int64)  # inv[old] = new
                vals = vals[inv_rows]
                idx = order[idx[inv_rows]].astype(np.int32)
        with clock.span("write"):
            write_topk_files(args.output, idx, vals)
    note = ""
    if args.engine == "spmm":
        note = " (kernel launches: " + ", ".join(
            f"{k} {SPMV_LAUNCHES[k] - launched[k]}" for k in SPMV_LAUNCHES) + ")"
    stages = _stages({k: ms / 1e3 for k, ms in times.items()})
    rows = ", ".join(f"{k} {WRITE_ROWS[k] - written[k]}" for k in WRITE_ROWS)
    print(f"wrote {args.output}(.sim.txt) ({stages}; rows written: {rows}){note}")
    return 0


def mc_main(args) -> int:
    """``uniwalk`` and ``topsim``: top-k files of every node of the graph."""
    import time

    from graphtpu_torch.core.config import TopSimConfig, UniWalkConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.io.simfile import write_topk_files

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    g = read_edgelist_graph(args.input, delimiter=args.delimiter)
    t1 = time.perf_counter()
    note = ""
    if args.cmd == "uniwalk":
        from graphtpu_torch.simrank.uniwalk import uniwalk_simrank

        vals, idx = uniwalk_simrank(
            g, UniWalkConfig(sample=args.sample, step=args.step, topk=args.topk),
            key=args.seed, device=device,
        )
    else:
        from graphtpu_torch.simrank.topsim import topsim_simrank

        stats = {}
        vals, idx = topsim_simrank(
            g,
            TopSimConfig(
                sample=args.sample, step=args.step, topk=args.topk,
                enumerate_all=(args.engine == "enumerate"),
                frontier_capacity=args.frontier_capacity,
            ),
            key=args.seed, device=device, stats=stats,
        )
        note = f", dropped mass {stats['dropped_mass']:g}"
    t2 = time.perf_counter()
    write_topk_files(args.output, idx, vals)
    t3 = time.perf_counter()
    print(f"wrote {args.output}(.sim.txt) (read {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, "
          f"write {t3 - t2:.3f} s{note})")
    return 0


def sweep_main(args) -> int:
    from graphtpu_torch.bench.sweep import (
        REFERENCE_SAMPLE_GRID,
        gold_standard,
        sweep_topsim,
        sweep_uniwalk,
    )
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.utils.logging import Log

    device = resolve_device(args.device)
    g = read_edgelist_graph(args.input, delimiter=args.delimiter)
    gold = gold_standard(g, device=device)
    samples = args.samples or REFERENCE_SAMPLE_GRID
    run = sweep_uniwalk if args.algorithm == "uniwalk" else sweep_topsim
    with Log(args.log) as log:
        res = run(g, gold, samples=samples, log=log, key=args.seed, device=device)
    for r in res:
        print(f"{r.algorithm} sample={r.sample}: precision={r.precision:.4f} "
              f"ndcg={r.ndcg:.4f} ({r.seconds:.1f}s)")
    return 0


def deepsim_main(args) -> int:
    import time

    from graphtpu_torch.core.config import DeepSimConfig, WalkConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.io.embfile import write_emb
    from graphtpu_torch.pipelines_deepsim import deepsim_pipeline

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    g = read_edgelist_graph(args.input, delimiter=args.delimiter,
                            n_nodes=args.vertex_num or None)
    t_graph = time.perf_counter() - t0
    times = {}
    emb = deepsim_pipeline(
        g, simrank_path=args.simrank_path,
        cfg=DeepSimConfig(dim=args.dimensions, window=args.window_size),
        walk_cfg=WalkConfig(), walks_cache=args.walks_cache, seed=args.seed,
        steps=args.steps, device=device, stage_times=times,
    )
    times["read"] += t_graph  # the edge file and the sim file
    t0 = time.perf_counter()
    write_emb(args.emb_output, emb)
    times["write"] = time.perf_counter() - t0
    print(f"wrote {args.emb_output} ({_stages(times)})")
    return 0


def generate_main(args) -> int:
    from graphtpu_torch.bench import generators as gen

    if args.kind == "massive":
        n = gen.massive_bipartite_graph(args.nodes, args.right or args.nodes, args.avg_degree,
                                        args.output, seed=args.seed)
        print(f"wrote {args.output}: {n} edges")
        return 0
    if args.kind == "uniform":
        edges = gen.uniform_random_graph(args.nodes, args.avg_degree, args.seed)
    elif args.kind == "bipartite":
        edges = gen.bipartite_random_graph(args.nodes, args.right or args.nodes,
                                           args.avg_degree, args.seed)
    elif args.kind == "directed":
        edges = gen.directed_random_graph(args.nodes, args.avg_degree, args.seed)
    else:  # rmat
        m = args.edges or (1 << args.scale) * args.avg_degree // 2
        edges = gen.rmat_graph(args.scale, m, seed=args.seed)
    np.savetxt(args.output, edges, fmt="%d")
    print(f"wrote {args.output}: {len(edges)} edges")
    return 0


def sdne_main(args) -> int:
    import time

    from graphtpu_torch.core.config import SDNEConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import dense_adjacency, read_edgelist_graph
    from graphtpu_torch.io.embfile import write_emb
    from graphtpu_torch.models.sdne import train_sdne

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    g = read_edgelist_graph(args.input, delimiter=args.delimiter)
    x = dense_adjacency(g, device=device)
    times = {"read": time.perf_counter() - t0}
    v = x.shape[1]
    units = [v, *args.hidden, v] if args.hidden else [v, 400, 100, 300, v]
    t0 = time.perf_counter()
    _, embed = train_sdne(x, SDNEConfig(units=tuple(units)), steps=args.steps,
                          log_every=max(args.steps // 10, 1), device=device)
    emb = embed(x)
    times["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_emb(args.output, emb)
    times["write"] = time.perf_counter() - t0
    print(f"wrote {args.output} ({_stages(times)})")
    return 0


def le_main(args) -> int:
    import time

    from graphtpu_torch.core.config import LEConfig
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.models.lapeigen import (
        le_embed_points,
        le_embed_sim_dict,
        make_swiss_roll,
    )

    device = resolve_device(args.device)
    cfg = LEConfig(k_neighbors=args.k, heat_t=args.t)
    times = {}
    t0 = time.perf_counter()
    if args.input:
        from graphtpu_torch.io.simfile import read_sim_file

        sims = read_sim_file(args.input)
        n = args.nodes or (
            max(max(s for s in sims), max(d for ps in sims.values() for d, _ in ps)) + 1)
        y, evals = le_embed_sim_dict(sims, n, cfg, device=device, stage_times=times)
    else:
        y, evals = le_embed_points(make_swiss_roll(2000), cfg, device=device, stage_times=times)
    times = {"embed": time.perf_counter() - t0, **times}
    t0 = time.perf_counter()
    np.save(args.output, y)
    times["write"] = time.perf_counter() - t0
    out = args.output if args.output.endswith(".npy") else f"{args.output}.npy"
    print(f"wrote {out} (eigenvalues {' '.join(repr(float(e)) for e in evals)}; "
          f"{_stages(times)})")
    if args.plot:
        from graphtpu_torch.viz import plot_embedding_2d

        png = args.output.rsplit(".npy", 1)[0] + ".png"
        plot_embedding_2d(y, png)
        print(f"wrote {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
