"""Runner of a TopSim mix: deterministic-spreading Monte-Carlo SimRank over
every source of a graph in memory.

One unit is ``topsim_simrank(g, TopSimConfig(c, step, sample, topk))``
over all sources, on a key drawn from (seed, unit index), the top-k on the
host.  The unit's record holds what the call added to the program's
``TOPSIM_COUNTS`` (``sources``, ``slots``, ``live``) and the mass its
frontiers dropped (``stats``); in the traced run the call also fills a
counted ``stage_times``, which holds those counts too.  Every answer of the
window is kept, and ``judge`` holds each to exact SimRank after STEP
iterations, solved once a run, as the UniWalk runner's does; the mix's
iterations must equal the configuration's ``step``.  A program without
``TOPSIM_COUNTS`` is refused before any solve.

After the window, further numbers compared, each the worst over the
window's solves:

* ``estimator_err``, ``estimator_rank_err``, ``bad_rows``: one seeded
  source tile of each solve against the plain estimator
  (``benchmark/reference/topsim.py``) on that tile's frontiers, made anew
  as the program's tile loop makes them (``topsim_tile_frontiers``: the
  tile's sources, the last tile padded with source 0, on stream
  ``key_for(solve key, lo)``), read as the UniWalk runner reads its tile;
* ``spread_bad``: the slots of that tile's frontiers, at every depth, that
  break the spreading rule (``reference.spread_bad``);
* ``dropped_mass``: the mass a solve's frontiers could not hold;
* ``precision_short``: 1 - the mean precision@k of a solve against the
  exact top-k (the judge's solve), as the UniWalk runner reads it;
* traced only, ``sources_short``: V less the fewest sources a solve
  counted.
"""

from __future__ import annotations

import numpy as np
import torch

import graphtpu_torch.simrank.topsim as ts
from benchmark import stages
from benchmark.reference import topsim as reference
from benchmark.runners import uniwalk as walk_runner


def _key(seed: int, index: int) -> int:
    return int(np.random.default_rng([seed, 1, index + 1]).integers(1 << 62))


def setup(ctx):
    from graphtpu_torch.core.config import TopSimConfig
    from graphtpu_torch.core.graph import build_graph

    if not hasattr(ts, "TOPSIM_COUNTS"):
        raise SystemExit("the program's topsim_simrank keeps no TOPSIM_COUNTS and takes no "
                         "stage_times: this cell cannot run it")
    if ctx.mode != "fast":
        raise SystemExit(f"the TopSim runner runs mode fast (float32), not {ctx.mode!r}")
    sr, spread = ctx.config["simrank"], ctx.config["topsim"]
    if int(ctx.traffic["iterations"]) != int(spread["step"]):
        raise SystemExit(f"the mix's {ctx.traffic['iterations']} iterations are not the "
                         f"configuration's step {spread['step']}")
    _, deg = reference.adjacency(ctx.edges, ctx.n_nodes)
    return {
        "g": build_graph(ctx.edges, n_nodes=ctx.n_nodes, device=ctx.device),
        "cfg": TopSimConfig(c=float(sr["c"]), step=int(spread["step"]),
                            sample=float(spread["sample"]), topk=int(sr["topk"])),
        "seed": ctx.seed, "device": ctx.device, "trace": ctx.trace, "edges": ctx.edges,
        "deg": deg, "n_nodes": ctx.n_nodes, "solves": [],
    }


def unit(state, rec):
    times = stages.Counted() if state["trace"] and rec["index"] >= 0 else None
    before = dict(ts.TOPSIM_COUNTS)
    stats = {}
    vals, idx = ts.topsim_simrank(state["g"], state["cfg"],
                                  key=_key(state["seed"], rec["index"]),
                                  device=state["device"], stats=stats, stage_times=times)
    rec["counts"] = {k: float(ts.TOPSIM_COUNTS[k] - n) for k, n in before.items()}
    rec["dropped_mass"] = stats["dropped_mass"]
    if times is not None:
        stages.keep_counts(rec, times)
        rec["stage_times"].update(rec["counts"])
    if rec["index"] >= 0:
        state["solves"].append((rec["index"], vals, idx))
    return vals, idx


judge = walk_runner.judge


def _tile_check(state, index: int, vals, idx) -> dict:
    """The estimator's numbers and the spreading rule's on one source tile
    of the solve ``index``, the tile drawn from (seed, index), its
    frontiers made anew from the solve's key."""
    from graphtpu_torch.core.prng import key_for

    g, cfg, dev, v = state["g"], state["cfg"], state["device"], state["n_nodes"]
    tile = min(cfg.source_tile, v)
    rng = np.random.default_rng([state["seed"], 2, index + 1])
    lo = tile * int(rng.integers(-(-v // tile)))
    m = min(tile, v - lo)
    src = torch.zeros(tile, dtype=torch.int32, device=dev)
    src[:m] = torch.arange(lo, lo + m, dtype=torch.int32, device=dev)
    frontiers, _ = ts.topsim_tile_frontiers(g, src, key_for(_key(state["seed"], index), lo), cfg)
    dense = reference.scores(frontiers[2::2], state["deg"], v, cfg.c, cfg.sample)
    out = walk_runner._tile_numbers(dense[:m], vals[lo:lo + m], idx[lo:lo + m])
    out["spread_bad"] = float(reference.spread_bad(frontiers, state["edges"], v, cfg.sample))
    return out


def numbers(state, units):
    cfg, v, solves = state["cfg"], state["n_nodes"], state["solves"]
    out = {}
    for index, vals, idx in solves:
        for name, x in _tile_check(state, index, vals, idx).items():
            out[name] = max(out.get(name, x), x)
    if solves:
        out["precision_short"] = max(walk_runner._precision_short(state["exact"], idx, cfg.topk)
                                     for _, _, idx in solves)
    counted = [u for u in units if u["index"] >= 0 and "counts" in u]
    if counted:
        out["dropped_mass"] = max(u["dropped_mass"] for u in counted)
        if state["trace"]:
            out["sources_short"] = float(v - min(u["counts"]["sources"] for u in counted))
    return out


def release(state):
    state.clear()
