"""Time TopSim's frontier expansion TS1 (``simrank/topsim.py``) at its cell's shape.

    python -m graphtpu_torch.bench.expand_probe [--rounds 3] [--out probe.json]

On one card: a uniform random graph of 32,768 nodes at average degree 32
(the shape of GAP's Urand at scale 15, edge factor 16) and one group of 16
tiles of 32 sources (T = 512) at SAMPLE 10,000 (W = 20,008 slots) and STEP
3 (paths of L = 7 nodes), each tile on its own keys as ``topsim_simrank``
draws them.  The plain version spreads the group; at each depth 0-5 the
kernel and the plain version take the same frontier and keys, and their
paths and masses are checked bit-equal (the dropped mass within
``DROP_RTOL`` of the plain version's).  Then, in turns for ``--rounds``
rounds, each the median of 9 CUDA-event runs: the kernel alone (one
launch on draws made once), the whole call on a CUDA tensor (the 16 tiles'
draws and the launch) and the plain version.  The bound is
:func:`graphtpu_torch.bench.bounds.expand_work` at 3.35 TB/s.  No PyTorch
call computes the same function, so there is no library yardstick.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
from statistics import median

import torch

from graphtpu_torch.bench import bounds
from graphtpu_torch.bench.timing import card, cuda_ms
from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.simrank import topsim as ts

V = 32_768
TILE, TILES = 32, 16
CFG = TopSimConfig(sample=10_000.0, step=3)
KEY = 2**45 + 17
# a row's dropped mass, summed in another order: a few float32 roundings
DROP_RTOL = 1e-5


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def expand_times(dev, rounds: int = 3) -> list:
    """One result a depth (see the module's docstring)."""
    from graphtpu_torch.bench.generators import uniform_random_graph
    from graphtpu_torch.core.graph import build_graph

    g = build_graph(uniform_random_graph(V, 32, seed=0), n_nodes=V, device=dev)
    t, w, length = TILE * TILES, ts.frontier_capacity(g, CFG), 2 * CFG.step + 1
    tile_keys = [key_for(KEY, lo) for lo in range(0, t, TILE)]
    paths = torch.full((t, w, length), -1, dtype=torch.int32, device=dev)
    paths[:, 0, 0] = torch.arange(t, dtype=torch.int32, device=dev)
    mass = torch.zeros((t, w), dtype=torch.float32, device=dev)
    mass[:, 0] = CFG.sample
    out = []
    for depth in range(2 * CFG.step):
        keys = [key_for(k, depth) for k in tile_keys]
        want = ts._expand_frontier_plain(g, paths, mass, depth, keys)
        got = ts._expand_frontier(g, paths, mass, depth, keys)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(_bits(got[1]), _bits(want[1]))):
            raise RuntimeError(f"TS1 differs from the plain version at depth {depth}")
        if not torch.allclose(got[2], want[2], rtol=DROP_RTOL, atol=0.0):
            raise RuntimeError(f"TS1's dropped mass differs at depth {depth}")
        del got
        u = ts._draws(t, w, keys, dev)
        cases = {"kernel": lambda: ts.ts1_expand(g, paths, mass, depth, u),
                 "call": lambda: ts._expand_frontier(g, paths, mass, depth, keys),
                 "plain": lambda: ts._expand_frontier_plain(g, paths, mass, depth, keys)}
        runs = {key: [] for key in cases}
        for r in range(rounds):
            for key in (cases if r % 2 == 0 else reversed(cases)):
                runs[key].append(cuda_ms(cases[key]))
        ms = {key: median(v) for key, v in runs.items()}
        bound_ms, bound_by = bounds.bound(*bounds.expand_work(t, w, length))
        out.append(dict(depth=depth, shape=[t, w, length],
                        live_parents=int((mass > 0).sum()), live_children=int((want[1] > 0).sum()),
                        ms=ms["kernel"], call_ms=ms["call"], plain_ms=ms["plain"],
                        bound_ms=bound_ms, bound_by=bound_by, of_bound=bound_ms / ms["kernel"],
                        runs=runs))
        paths, mass = want[0], want[1]
        del u, want
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("expand_probe needs a CUDA device")
    res = {"card": card(), "depths": expand_times(torch.device("cuda"), args.rounds)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
