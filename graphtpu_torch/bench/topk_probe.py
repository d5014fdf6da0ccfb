"""Time the row top-k kernel (``kernels/topk.py``) at the shapes of its cells.

    python -m graphtpu_torch.bench.topk_probe [--rounds 3] [--out probe.json]

On one card, k = 20: the exact SimRank scores of a uniform random graph
and of a Graph500-shaped R-MAT graph at V = 32,768 (30 kahan iterations,
the diagonal zeroed: the gold cells' [32,768, 32,768] f32 input; R-MAT's
isolated nodes give all-zero rows), and UniWalk's [256, 50,000] f32 tile
of candidate totals, ~70% -inf.  Each input's top-k by the kernel, by the
plain version (a stable ``torch.sort`` of every row) and by ``torch.topk``
(the library yardstick only: it promises no order among ties), in turns
for ``--rounds`` rounds, each time the median of 9 CUDA-event runs; the
kernel's values and indices are checked bit-equal to the plain version's
once, and each path's rise of ``max_memory_allocated`` over one call is
kept.  The bound is :func:`graphtpu_torch.bench.bounds.topk_work` at
3.35 TB/s.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
from statistics import median

import numpy as np
import torch

from graphtpu_torch.bench import bounds
from graphtpu_torch.bench.timing import card, cuda_ms
from graphtpu_torch.kernels import topk

V = 32_768
TOPK = 20


def simrank_scores(dev, kind: str) -> torch.Tensor:
    """[V, V] f32 exact SimRank scores, diagonal zeroed, of a uniform random
    graph (average degree 32) or an R-MAT graph of scale 15, edge factor 16."""
    from graphtpu_torch.bench.generators import rmat_graph, uniform_random_graph
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.graph import build_graph
    from graphtpu_torch.simrank.exact import exact_simrank_spmm

    if kind == "urand":
        edges = uniform_random_graph(V, 32, seed=0)
    else:
        edges = rmat_graph(15, 16 * V, seed=0)
    g = build_graph(edges, n_nodes=V, device=dev)
    return exact_simrank_spmm(g, SimRankConfig(iterations=30), device=dev)


def uniwalk_tile(dev) -> torch.Tensor:
    """[256, 50,000] f32: positive totals at ~30% of the items, -inf at the rest."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((256, 50_000), generator=gen, device=dev)
    live = torch.rand((256, 50_000), generator=gen, device=dev) < 0.3
    return torch.where(live, x * 1e-3, float("-inf"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def topk_times(name: str, x: torch.Tensor, k: int = TOPK, rounds: int = 3) -> dict:
    """The times and memory rises of one input (see the module's docstring)."""
    rows, n = x.shape
    kv, ki = topk._stable_topk(x, k)
    pv, pi = topk.stable_topk_plain(x, k)
    if not (torch.equal(_bits(kv), _bits(pv)) and torch.equal(ki, pi)):
        raise RuntimeError(f"top-k kernel differs from the plain version ({name})")
    del kv, ki, pv, pi
    cases = {"kernel": lambda: topk._stable_topk(x, k),
             "plain": lambda: topk.stable_topk_plain(x, k),
             "library": lambda: torch.topk(x, k, dim=1)}
    rise = {}
    for key, fn in cases.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        rise[key] = torch.cuda.max_memory_allocated() - base
        del out
    runs = {key: [] for key in cases}
    for r in range(rounds):
        for key in (cases if r % 2 == 0 else reversed(cases)):
            runs[key].append(cuda_ms(cases[key]))
    bound_ms, bound_by = bounds.bound(*bounds.topk_work(rows, n, k, x.element_size()))
    ms = {key: median(t) for key, t in runs.items()}
    return dict(input=name, shape=[rows, n], dtype=str(x.dtype).replace("torch.", ""), k=k,
                ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                bound_ms=bound_ms, bound_by=bound_by, of_bound=bound_ms / ms["kernel"],
                rise_bytes=rise, runs=runs)


def probe(dev, rounds: int = 3) -> list:
    """The three inputs' results, in order: urand, R-MAT, UniWalk."""
    cases = []
    for kind in ("urand", "rmat"):
        s = simrank_scores(dev, kind)
        cases.append(topk_times(f"simrank_{kind}", s, rounds=rounds))
        zero_rows = int((s == 0).all(dim=1).sum().item())
        cases[-1]["zero_rows"] = zero_rows
        del s
        torch.cuda.empty_cache()
    cases.append(topk_times("uniwalk_tile", uniwalk_tile(dev), rounds=rounds))
    return cases


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("topk_probe needs a CUDA device")
    res = {"card": card(), "cases": probe(torch.device("cuda"), args.rounds)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
