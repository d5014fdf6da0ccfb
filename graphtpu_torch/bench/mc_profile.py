"""Where the Monte-Carlo engines' time goes on the card: one UniWalk tile,
one TopSim tile and one flagship-shaped reuse tile on the blog-shaped
graph, profiled.

    python -m graphtpu_torch.bench.mc_profile [--out profile.json]
    env PYTHONPATH=DIR python graphtpu_torch/bench/mc_profile.py   # DIR's package

Cases (the CLI defaults; the flagship's SAMPLE 10,000, TIMES 4, STEP 5):
a UniWalk tile of 256 sources x 10,000 walks of 10 hops, its walks, items
and ``segment_topk`` alone; a TopSim tile of 32 sources (sample 10,000,
step 3, 20,008 slots); a reuse tile of 512 sources x 2,500 walks of 13
hops, its walks and items alone, and its ``pair_topk_by_source``.  For
each, the host ms of one call (median, ended by a synchronise), the ms the
card was busy in it, its device kernels and the ops with the most host and
device time (``embed_profile.profile_case``).  Needs a card; prints one
JSON object last.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from graphtpu_torch.bench.embed_profile import profile_case


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mc_profile needs a CUDA device")
    dev = torch.device("cuda")
    from graphtpu_torch.bench.generators import blog_shaped_graph
    from graphtpu_torch.core.config import TopSimConfig, UniWalkConfig
    from graphtpu_torch.kernels.topk import pair_topk_by_source, segment_topk
    from graphtpu_torch.simrank import topsim as ts
    from graphtpu_torch.simrank import uniwalk as uw
    from graphtpu_torch.walks.walker import uniform_walks

    g = blog_shaped_graph(device=dev)
    v = g.n_nodes
    ucfg, tcfg = UniWalkConfig(), TopSimConfig()
    fcfg = UniWalkConfig(sample=10_000, step=5, reuse_times=4)
    usrc = torch.arange(ucfg.source_tile, dtype=torch.int32, device=dev)
    tsrc = torch.arange(tcfg.source_tile, dtype=torch.int32, device=dev)
    fsrc = torch.arange(512, dtype=torch.int32, device=dev)
    cap = ts.frontier_capacity(g, tcfg)
    walks = uw._tile_walks(g, usrc, 1, ucfg.sample, ucfg.step)
    targets, vals = uw._tile_items(g.deg, walks, ucfg.step, ucfg.c, ucfg.sample)
    fstarts = torch.repeat_interleave(fsrc, fcfg.sample // fcfg.reuse_times)
    flen = 2 * fcfg.step + fcfg.reuse_times - 1
    fwalks = uniform_walks(g, fstarts, flen, 2, device=dev)
    srcs, tgts, fvals, counts = uw._reuse_stream(g, fcfg, fwalks)

    cases = {
        "UniWalk tile, 256 x 10,000 walks x 10 hops": lambda: uw.uniwalk_tile_topk(
            g, usrc, 1, ucfg),
        "  its walks": lambda: uw._tile_walks(g, usrc, 1, ucfg.sample, ucfg.step),
        "  its items": lambda: uw._tile_items(g.deg, walks, ucfg.step, ucfg.c, ucfg.sample),
        "  its segment_topk, 12.8 M items": lambda: segment_topk(targets, vals, ucfg.topk, v),
        f"TopSim tile, 32 sources, {cap:,} slots": lambda: segment_topk(
            *ts.topsim_tile_items(g, tsrc, 1, tcfg, cap)[:2], tcfg.topk, v),
        "reuse tile, 512 x 2,500 walks x 13 hops": lambda: pair_topk_by_source(
            *uw._reuse_stream(g, fcfg, uniform_walks(g, fstarts, flen, 2, device=dev))[:3],
            fsrc, fcfg.topk, counts=counts),
        "  its walks and items": lambda: uw._reuse_stream(
            g, fcfg, uniform_walks(g, fstarts, flen, 2, device=dev)),
        "  its pair_topk_by_source, 25.6 M items": lambda: pair_topk_by_source(
            srcs, tgts, fvals, fsrc, fcfg.topk, counts=counts),
    }
    out = {"card": torch.cuda.get_device_name(0), "cases": {}}
    for name, fn in cases.items():
        r = profile_case(fn)
        out["cases"][name.strip()] = r
        print(f"{name}: host {r['host_ms']:.3f} ms, card busy {r['busy_ms']:.3f} ms, "
              f"{r['kernels']:.0f} kernels", flush=True)
        print("  most device time: " + "; ".join(f"{k} x{c} {us:.0f} us"
                                                 for k, c, us in r["top_device_us"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
