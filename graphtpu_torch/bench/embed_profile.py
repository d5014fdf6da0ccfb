"""Where the embedding path's time goes on the card: one walk hop and one
SGNS step at the blog shapes, profiled.

    python -m graphtpu_torch.bench.embed_profile [--out profile.json]
    env PYTHONPATH=DIR python graphtpu_torch/bench/embed_profile.py   # DIR's package

For a uniform hop (B = 65,536), a node2vec rejection hop (p = 1, q = 2,
B = 32,768, the blog graph's bitmap edge set) and an SGNS step (B = 8192,
W = 10, N = 5 shared, D = 128) on the blog-shaped graph it prints the
host ms of one call (median of 20, ended by a synchronise), the ms the
card was busy in it (the union of the profiler's device intervals), its
device kernels, and the ops with the most host and device time; and the
host µs of one ``torch.Generator`` made and seeded on the card.  Needs a
card; prints one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from graphtpu_torch.bench.timing import busy_ms_of

CALLS = 5  # profiled calls per case


def profile_case(fn, top: int = 8) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    by_host = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:top]
    by_dev = sorted(avgs, key=lambda e: -dev_us(e))[:top]
    return dict(
        host_ms=float(np.median(host)),
        busy_ms=busy_ms_of(events) / CALLS,
        kernels=kernels / CALLS,
        top_host_us=[(e.key, e.count // CALLS, e.self_cpu_time_total / CALLS) for e in by_host],
        top_device_us=[(e.key, e.count // CALLS, dev_us(e) / CALLS) for e in by_dev
                       if dev_us(e) > 0],
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("embed_profile needs a CUDA device")
    dev = torch.device("cuda")
    from graphtpu_torch.bench.generators import blog_shaped_graph
    from graphtpu_torch.core.config import SGNSConfig
    from graphtpu_torch.core.prng import generator, key_for
    from graphtpu_torch.kernels.edgeset import device_edge_set
    from graphtpu_torch.kernels.sampling import uniform_neighbor
    from graphtpu_torch.models import sgns
    from graphtpu_torch.walks import node2vec as n2v
    from graphtpu_torch.walks.walker import simulate_walks

    g = blog_shaped_graph(device=dev)
    es = device_edge_set(g)
    nodes = np.flatnonzero(g.host[3] > 0).astype(np.int32)
    cur1 = torch.from_numpy(np.random.default_rng(1).choice(nodes, size=65536)).to(dev)
    w = n2v.node2vec_walks(g, torch.from_numpy(np.random.default_rng(2).choice(nodes, size=32768)),
                           10, 1.0, 2.0, 3, eset=es, device=dev)
    prev, cur = w[:, 9].contiguous(), w[:, 10].contiguous()
    t = n2v.default_max_trials(1.0, 2.0)
    gen = generator(5, dev)

    cfg = SGNSConfig()
    corpus = simulate_walks(g, 2, 80, 11, p=1.0, q=2.0, device=dev)
    counts = sgns.corpus_counts(corpus, g.n_nodes)
    neg_j, neg_q = sgns.build_negative_alias(counts)
    cwalks, _ = sgns.subsample_and_compact(corpus, counts, cfg.subsample, gen)
    slots = torch.randperm(corpus.numel(), generator=gen, device=dev)[:cfg.batch_size]
    params = (torch.rand((g.n_nodes, cfg.dim), generator=gen, device=dev) - 0.5) / cfg.dim, \
        torch.zeros((g.n_nodes, cfg.dim), device=dev)

    def sgns_step():
        return sgns.batch_step(params, cwalks, slots, cfg.window, neg_j, neg_q,
                               (cfg.batch_size, cfg.negative), gen, 0.01, g.n_nodes)

    cases = {
        "uniform hop, B = 65,536": lambda: uniform_neighbor(g, cur1, generator(key_for(0, 1), dev)),
        "node2vec hop p=1 q=2, B = 32,768": lambda: n2v._second_order_step_rejection(
            g, None, es, prev, cur, 7, 1.0, 0.5, t, False),
        "SGNS step, B = 8192, W = 10, N = 5, D = 128": sgns_step,
    }
    out = {"card": torch.cuda.get_device_name(0), "cases": {}}
    for name, fn in cases.items():
        r = profile_case(fn)
        out["cases"][name] = r
        print(f"{name}: host {r['host_ms']:.3f} ms, card busy {r['busy_ms']:.3f} ms, "
              f"{r['kernels']:.0f} kernels", flush=True)
        print("  most host time: " + "; ".join(f"{k} x{c} {us:.0f} us"
                                               for k, c, us in r["top_host_us"]))
        print("  most device time: " + "; ".join(f"{k} x{c} {us:.0f} us"
                                                 for k, c, us in r["top_device_us"]))
    n = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        generator(key_for(9, i), dev)
    out["generator_us"] = 1e6 * (time.perf_counter() - t0) / n
    print(f"one torch.Generator made and seeded on the card: {out['generator_us']:.1f} us (host)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
