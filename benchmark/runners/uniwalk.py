"""Runner of a UniWalk mix: single-walk Monte-Carlo SimRank over every
source of a graph in memory.

One unit is ``uniwalk_simrank(g, UniWalkConfig(c, step, sample, topk))``
over all sources, on a key drawn from (seed, unit index), the top-k on the
host.  The unit's record holds what the call added to the program's
``UNIWALK_COUNTS`` (``walkers``, ``hops``); in the traced run the call
also fills a counted ``stage_times``, which holds those counts too.  Every
answer of the window is kept, and ``judge`` holds each to exact SimRank
after STEP iterations (``check.judge_simrank``), solved once a run; the
mix's iterations must equal the configuration's ``step``.

After the window, further numbers compared, each the worst over the
window's solves:

* ``estimator_err``, ``estimator_rank_err``: one seeded source tile of each
  solve against the plain estimator (``benchmark/reference/uniwalk.py``) on
  that tile's walks, made anew as the program's tile loop makes them: the
  tile's sources (the last tile padded with source 0), SAMPLE walkers each,
  the program's ``uniform_walks`` on stream ``key_for(solve key, lo)``.
  ``check.judge_topk``'s ``score_err`` and ``rank_err``, each row scaled as
  there; an id out of range or repeated counts in ``bad_rows``;
* ``precision_short``: 1 - the mean precision@k of a solve against the
  exact top-k (the judge's solve), over rows whose exact top-1 is above 0,
  k' = min(k, the row's positive scores);
* ``walkers_short``: V·SAMPLE less the fewest walkers a solve counted;
* ``hops_short``: 2·STEP·SAMPLE hops from each source with a neighbour
  (on an undirected graph such a walk never stops short) less the fewest
  hops a solve counted, those of the walks that reached their last node.
"""

from __future__ import annotations

import numpy as np
import torch

import graphtpu_torch.simrank.uniwalk as uw
from benchmark import check, stages
from benchmark.reference import uniwalk as reference


def _key(seed: int, index: int) -> int:
    return int(np.random.default_rng([seed, 1, index + 1]).integers(1 << 62))


def setup(ctx):
    from graphtpu_torch.core.config import UniWalkConfig
    from graphtpu_torch.core.graph import build_graph

    if ctx.mode != "fast":
        raise SystemExit(f"the UniWalk runner runs mode fast (float32), not {ctx.mode!r}")
    sr, walk = ctx.config["simrank"], ctx.config["uniwalk"]
    if int(ctx.traffic["iterations"]) != int(walk["step"]):
        raise SystemExit(f"the mix's {ctx.traffic['iterations']} iterations are not the "
                         f"configuration's step {walk['step']}")
    return {
        "g": build_graph(ctx.edges, n_nodes=ctx.n_nodes, device=ctx.device),
        "cfg": UniWalkConfig(c=float(sr["c"]), step=int(walk["step"]),
                             sample=int(walk["sample"]), topk=int(sr["topk"])),
        "seed": ctx.seed, "device": ctx.device, "trace": ctx.trace, "edges": ctx.edges,
        "deg": reference.degrees(ctx.edges, ctx.n_nodes), "n_nodes": ctx.n_nodes,
        "solves": [],
    }


def unit(state, rec):
    times = stages.Counted() if state["trace"] and rec["index"] >= 0 else None
    before = dict(uw.UNIWALK_COUNTS)
    vals, idx = uw.uniwalk_simrank(state["g"], state["cfg"],
                                   key=_key(state["seed"], rec["index"]),
                                   device=state["device"], stage_times=times)
    rec["counts"] = {k: float(uw.UNIWALK_COUNTS[k] - n) for k, n in before.items()}
    if times is not None:
        stages.keep_counts(rec, times)
        rec["stage_times"].update(rec["counts"])
    if rec["index"] >= 0:
        state["solves"].append((rec["index"], vals, idx))
    return vals, idx


def judge(state, kept):
    """Each kept solve's ``check.judge_topk`` numbers against exact SimRank
    after STEP iterations, solved once and left in ``state["exact"]`` for
    :func:`numbers`."""
    cfg = state["cfg"]
    judged, state["exact"] = check.judge_simrank(state["edges"], state["n_nodes"], cfg.c,
                                                 cfg.step, cfg.topk, state["device"],
                                                 [(vals, idx, 0) for vals, idx in kept])
    return judged


def _tile_numbers(dense: torch.Tensor, vals, idx) -> dict:
    """``estimator_err``, ``estimator_rank_err`` and ``bad_rows`` of a tile's
    top-k (vals, idx) [T, k] against the plain estimates ``dense`` [T, V],
    as ``check.judge_topk`` reads a [V, k] answer against the reference."""
    v = dense.shape[1]
    ids = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dense.device)
    got = torch.as_tensor(np.asarray(vals, np.float64), device=dense.device)
    top = torch.topk(dense, ids.shape[1], dim=1).values
    scale = torch.clamp(top[:, 0], min=float(top[:, 0].median()))[:, None]
    srt = torch.sort(ids, dim=1).values
    ok = ((ids >= 0) & (ids < v)).all(dim=1) & (srt[:, 1:] != srt[:, :-1]).all(dim=1)
    ok = ok[:, None]
    at = torch.gather(dense, 1, ids.clamp(0, v - 1))
    return {
        "estimator_err": float(torch.where(ok, (got - at).abs() / scale, 0).max()),
        "estimator_rank_err": float(torch.where(ok, (top - at) / scale, 0).max()),
        "bad_rows": float((~ok).sum()),
    }


def _tile_check(state, index: int, vals, idx) -> dict:
    """The estimator's numbers on one source tile of the solve ``index``,
    the tile drawn from (seed, index), its walks made anew from the key."""
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.walks.walker import uniform_walks

    g, cfg, dev, v = state["g"], state["cfg"], state["device"], state["n_nodes"]
    tile = min(cfg.source_tile, v)
    rng = np.random.default_rng([state["seed"], 2, index + 1])
    lo = tile * int(rng.integers(-(-v // tile)))
    m = min(tile, v - lo)
    src = torch.zeros(tile, dtype=torch.int32, device=dev)
    src[:m] = torch.arange(lo, lo + m, dtype=torch.int32, device=dev)
    walks = uniform_walks(g, torch.repeat_interleave(src, cfg.sample), 2 * cfg.step,
                          key_for(_key(state["seed"], index), lo), device=dev)
    walks = walks.reshape(tile, cfg.sample, 2 * cfg.step + 1)[:m]
    dense = reference.scores(walks, state["deg"], v, cfg.c)
    return _tile_numbers(dense, vals[lo:lo + m], idx[lo:lo + m])


def _precision_short(exact: torch.Tensor, idx, k: int) -> float:
    """1 - the mean precision@k of ids [V, k] against the exact scores'
    top-k, over rows whose exact top-1 is above 0."""
    top = torch.topk(exact, k, dim=1)
    real_k = (exact > 0).sum(dim=1).clamp(max=k)
    gold = torch.where(torch.arange(k, device=exact.device) < real_k[:, None], top.indices, -2)
    ids = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=exact.device)
    hits = (ids[:, :, None] == gold[:, None, :]).any(dim=2).sum(dim=1)
    rows = top.values[:, 0] > 0
    return float(1.0 - (hits[rows].double() / real_k[rows]).mean())


def numbers(state, units):
    cfg, v, solves = state["cfg"], state["n_nodes"], state["solves"]
    out = {}
    for index, vals, idx in solves:
        for name, x in _tile_check(state, index, vals, idx).items():
            out[name] = max(out.get(name, x), x)
    if solves:
        out["precision_short"] = max(_precision_short(state["exact"], idx, cfg.topk)
                                     for _, _, idx in solves)
    counted = [u["counts"] for u in units if u["index"] >= 0 and "counts" in u]
    if counted:
        live = int((state["deg"] > 0).sum())
        out["walkers_short"] = float(v * cfg.sample - min(c["walkers"] for c in counted))
        out["hops_short"] = float(live * cfg.sample * 2 * cfg.step
                                  - min(c["hops"] for c in counted))
    return out


def release(state):
    state.clear()
