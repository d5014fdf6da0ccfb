"""The 10M-vertex flagship at the reference's budget shape (counterpart of
``tools/run_10m_flagship.py``).

Reference: ``giraph/CombineBatchSingleWalkVertexReuse.java:39-48``:
V = 10,000,000, SAMPLE = 10,000 walkers a source, STEP = 5, path reuse
TIMES = 4 (2,500 physical walks of length 2·STEP + TIMES - 1 feed 4 offset
samples each), the query set stopV = 100,000, source windows BATCH =
40,000, 14 workers.

Each window's tiles start ``SAMPLE/TIMES`` walks per query source, build
the flat reuse item stream (offset sources outside the tile are culled by
the top-k extraction: the stopV message cull,
``NormalCombineBatchSingleWalkVertexReuse.java:81-100``), normalise by the
samples each source received (the flush normalisation, ``flushTest:79-94``)
and reduce scatter-free with ``pair_topk_by_source``.  A durable window
cursor and part files let an interrupted run resume
(``BatchSingleWalkVertex.java:108-133``).

Usage (on the card):

    python -m graphtpu_torch.bench.flagship [V] [avg_deg] [sample] [times]
        [stopV] [window] [tile] [budget_s]

The graph is generated once by the C++ generator into
``results/flagship_graphs/g_{V}_{avg_deg}.txt`` with its ``.csr.npz``
cache beside it; the windows, their stats file and the cursor go to
``results/flagship_torch_{V}_{sample}`` (``$GRAPHTPU_FLAGSHIP_DIR``
overrides it).  The last line of output is one JSON object.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEP, TOPK, C = 5, 20, 0.6  # the flagship's constants (...Reuse.java:39-48)


class Budget(Exception):
    """The run's time (or window) budget is spent; the cursor holds."""


def run_flagship(
    v: int = 10_000_000,
    avg_deg: int = 8,
    sample: int = 10_000,
    times: int = 4,
    stop_v: int = 100_000,
    window: int = 40_000,
    tile: int = 2048,
    budget_s: float = 1e9,
    graph_path: Optional[str] = None,
    out_dir: Optional[str] = None,
    device=None,
    window_budget: Optional[int] = None,
    log=print,
) -> dict:
    """Run (or resume) the flagship sweep on ``device`` (default ``cuda``).

    Stops cleanly, cursor saved, once ``budget_s`` seconds from the start
    have passed or this call has run ``window_budget`` windows, at the next
    window boundary.  Returns the run's record: the final JSON line's keys
    (when a window ran) plus ``generate_s``, ``load_s``, ``tile_s`` (each
    tile's seconds), ``complete`` and ``peak_gb`` (the card's peak memory;
    None on the CPU)."""
    from graphtpu_torch import native
    from graphtpu_torch.bench.timing import card
    from graphtpu_torch.core.device import resolve_device
    from graphtpu_torch.core.graph import load_graph_cached
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.dist.windows import windowed_topk_sweep
    from graphtpu_torch.kernels.topk import pair_topk_by_source, segment_sum_1d
    from graphtpu_torch.simrank.uniwalk import _reuse_items
    from graphtpu_torch.walks.walker import uniform_walks

    dev = resolve_device(device)
    t_start = time.time()
    deadline = t_start + budget_s
    wpn = max(sample // times, 1)
    length = 2 * STEP + (times - 1)
    rec = {"generate_s": None, "tile_s": [], "complete": False}

    path = graph_path or os.path.join(REPO, "results", "flagship_graphs", f"g_{v}_{avg_deg}.txt")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        t0 = time.time()
        n = native.generate_graph(path, "uniform", v, 0, target_edges=v * avg_deg // 2, seed=1)
        rec["generate_s"] = time.time() - t0
        log(f"generated {n} edges in {rec['generate_s']:.1f}s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    g = load_graph_cached(path, n_nodes=v, device=dev)
    rec["load_s"] = time.time() - t0
    log(f"graph: V={g.n_nodes} slots={g.n_edges} max_deg={g.max_degree} "
        f"load={rec['load_s']:.1f}s")

    out_dir = out_dir or os.environ.get("GRAPHTPU_FLAGSHIP_DIR") or os.path.join(
        REPO, "results", f"flagship_torch_{v}_{sample}")
    hops_per_tile = tile * wpn * length
    stats = {"windows": 0, "tiles": 0, "wall": 0.0}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    where = card() if dev.type == "cuda" else "cpu"

    def reuse_tile(chunk: np.ndarray, key: int):
        src = torch.from_numpy(chunk).to(dev)
        walks = uniform_walks(g, torch.repeat_interleave(src, wpn), length, key, device=dev)
        srcs, tgts, vals, cnt_src = _reuse_items(g.deg, walks, STEP, C, times)
        del walks
        counts = segment_sum_1d(cnt_src, torch.ones_like(cnt_src, dtype=torch.float32), v)
        return pair_topk_by_source(srcs, tgts, vals, src, TOPK, counts=counts)

    def compute_tile(sources: np.ndarray, key: int):
        if time.time() > deadline or (window_budget is not None
                                      and stats["windows"] >= window_budget):
            raise Budget
        n = len(sources)
        out_v = np.zeros((n, TOPK), np.float32)
        out_i = np.zeros((n, TOPK), np.int32)
        t0 = time.time()
        for lo in range(0, n, tile):
            hi = min(lo + tile, n)
            chunk = sources[lo:hi]
            if len(chunk) < tile:
                # pad with the last source so the ascending order (and the
                # leading hi - lo real rows) survive
                chunk = np.concatenate([chunk, np.full(tile - len(chunk), chunk[-1], np.int32)])
            sync()
            tt = time.time()
            vals, idx = reuse_tile(chunk, key_for(key, lo))
            # rows come back in sorted-source order; windows pass ascending
            # contiguous ranges, so that is the input order
            out_v[lo:hi] = vals.cpu().numpy()[: hi - lo]
            out_i[lo:hi] = idx.cpu().numpy()[: hi - lo]
            rec["tile_s"].append(time.time() - tt)
            log(f"    tile {lo}: {rec['tile_s'][-1]:.3f}s")
            stats["tiles"] += 1
        stats["windows"] += 1
        stats["wall"] += time.time() - t0
        n_tiles = n // tile + (n % tile > 0)
        log(f"  window {stats['windows']}: {time.time() - t0:.1f}s "
            f"({hops_per_tile * n_tiles / (time.time() - t0) / 1e6:.1f} M hops/s)")
        # durable per-window stats beside the parts
        with open(os.path.join(out_dir, "stats.json"), "w") as f:
            json.dump({"V": v, "sample": sample, "times": times, "step": STEP,
                       "stopV": stop_v, "window": window, "tile": tile, "mode": "eager",
                       "device": where, **stats,
                       "hops_per_s_session": round(stats["tiles"] * hops_per_tile
                                                   / max(stats["wall"], 1e-9))}, f)
        return out_v, out_i

    t0 = time.time()
    try:
        windowed_topk_sweep(compute_tile, stop_v, out_dir, window=window, key=13)
        rec["complete"] = True
        log(f"query sweep complete: {time.time() - t0:.1f}s")
    except Budget:
        ckpt = os.path.join(out_dir, "checkpoint.json")
        cursor = None
        if os.path.exists(ckpt):  # absent when no window ran yet
            with open(ckpt) as f:
                cursor = json.load(f)
        log(f"budget expired cleanly; cursor={cursor}")
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    if stats["windows"] == 0:
        return rec
    hops = stats["tiles"] * hops_per_tile
    line = {"V": v, "slots": int(g.n_edges), "sample": sample, "times": times, "step": STEP,
            "stopV": stop_v, "window": window, "windows_done": stats["windows"],
            "total_hops": hops, "device_wall_s": round(stats["wall"], 1),
            "hops_per_s": round(hops / stats["wall"]),
            "per_window_s": round(stats["wall"] / stats["windows"], 1),
            "total_wall_s": round(time.time() - t0, 1), "device": where}
    rec.update(line)
    parts = sorted(p for p in os.listdir(out_dir) if p.endswith(".sim.txt"))
    if parts:
        with open(os.path.join(out_dir, parts[0])) as f:
            log(f"part sample: {f.readline()[:120]}")
    log(json.dumps(line))
    return rec


def main(argv=None) -> int:
    import faulthandler

    argv = sys.argv[1:] if argv is None else argv
    names = ("v", "avg_deg", "sample", "times", "stop_v", "window", "tile", "budget_s")
    kw = {k: (float if k == "budget_s" else int)(a) for k, a in zip(names, argv)}
    faulthandler.dump_traceback_later(300, repeat=True)
    run_flagship(**kw, log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
