"""Where DeepSim's and SDNE's step time goes on the card, at the blog shapes.

    python -m graphtpu_torch.bench.model_profile [--out profile.json]

On the blog-shaped edge file's graph (V' = 10,240) with its node2vec walks
(10 x 80, p = q = 1) and a sim table of 20 random neighbours a node (the
step's cost does not depend on the values): one DeepSim step (B = 128,
window 10, dim 128) and its parts alone (the window batch with its sim
lookups, the loss forward, forward and backward, the Adam update), and
one SDNE step on the dense adjacency (units [10,240, 400, 100, 300,
10,240], minibatch 100).  For each: the host ms of one call (median of
20, ended by a synchronise), the ms the card was busy in it, its device
intervals, and the ops with the most host and device time.  Then the
host seconds of ``train_deepsim`` for 2,000 steps in this process, the
``deepsim`` CLI's train stage.  Needs a card; prints one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from graphtpu_torch.bench.embed_profile import profile_case


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("model_profile needs a CUDA device")
    dev = torch.device("cuda")
    from graphtpu_torch import build_graph
    from graphtpu_torch.bench.generators import blog_shaped_edges
    from graphtpu_torch.core.config import DeepSimConfig, SDNEConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.core.graph import dense_adjacency
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.models import deepsim as ds
    from graphtpu_torch.models import sdne
    from graphtpu_torch.walks.walker import simulate_walks

    g = build_graph(blog_shaped_edges())
    v = g.n_nodes
    rng = np.random.default_rng(0)
    sims = {s: [(int(d), float(x)) for d, x in zip(rng.choice(v, 20, replace=False),
                                                   rng.random(20))] for s in range(v)}
    table = ds.build_sim_table(sims, v, device=dev)
    walks = simulate_walks(g, 10, 80, key_for(0, 0), device=dev)
    cfg = DeepSimConfig()
    trainer = ds.Trainer(walks, table, ds.init_params(cfg, v, key_for(0, 2), dev), cfg,
                         key_for(0, 3), dev)
    model, k = trainer.model, cfg.window
    batch = ds.window_batch(walks, table, *trainer.draws(), k)

    def forward():
        with torch.no_grad():
            model.loss(*batch)

    def forward_backward():
        trainer.opt.zero_grad()
        model.loss(*batch).backward()

    adj = dense_adjacency(g, device=dev)
    scfg = SDNEConfig(units=(v, 400, 100, 300, v))
    strainer = sdne.Trainer(adj, sdne.init_params(scfg, key_for(0, 1), dev), scfg, dev)

    cases = {
        "DeepSim step, V = 10,240, B = 128, window 10, dim 128": trainer.step,
        "  its draws and window batch (sim lookups, dedup)":
            lambda: ds.window_batch(walks, table, *trainer.draws(), k),
        "  its loss forward": forward,
        "  its loss forward and backward": forward_backward,
        "  its Adam update": trainer.opt.step,
        "SDNE step, units [10,240, 400, 100, 300, 10,240], minibatch 100": strainer.step,
    }
    out = {"card": torch.cuda.get_device_name(0), "cases": {}}
    with full_fp32():
        for name, fn in cases.items():
            r = profile_case(fn)
            out["cases"][name.strip()] = r
            print(f"{name}: host {r['host_ms']:.3f} ms, card busy {r['busy_ms']:.3f} ms, "
                  f"{r['kernels']:.0f} device intervals", flush=True)
            print("    most host time: " + "; ".join(f"{k} x{c} {us:.0f} us"
                                                   for k, c, us in r["top_host_us"]))
            print("    most device time: " + "; ".join(f"{k} x{c} {us:.0f} us"
                                                     for k, c, us in r["top_device_us"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds.train_deepsim(walks, table, v, cfg, key=1, steps=2000, device=dev)
    out["train_deepsim_2000_s"] = time.perf_counter() - t0
    print(f"train_deepsim, 2,000 steps in this process: {out['train_deepsim_2000_s']:.3f} s "
          "(host)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
