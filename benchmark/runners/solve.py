"""Runner of a solve mix: the library entry on a graph already in memory.

One unit is ``exact_simrank_spmm(g, SimRankConfig(c, iterations),
spmv_mode=..., dtype=...)`` then ``simrank_topk(sim, topk)``, the result
on the host.  Each call builds its own plan, as a user's call does.  In the
traced run the call fills ``stage_times``, which also counts the times
each stage was added: a solve that ran fewer products than the mix's
iterations reads ``iterations_short`` above 0.
Every answer of the window is kept and judged against the float64 SimRank
of the configuration after the mix's iterations, solved with the graph
freed.
"""

from __future__ import annotations

import importlib

import torch

from benchmark import check, stages
from benchmark.precision import MODES


def setup(ctx):
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.core.graph import build_graph

    sr = ctx.config["simrank"]
    spmv_mode, dtype = MODES[ctx.mode]
    return {
        "g": build_graph(ctx.edges, n_nodes=ctx.n_nodes, device=ctx.device),
        "cfg": SimRankConfig(c=float(sr["c"]), iterations=int(ctx.traffic["iterations"])),
        "k": int(sr["topk"]), "mode": (spmv_mode, getattr(torch, dtype)),
        "device": ctx.device, "stage_times": ctx.trace,
        "edges": ctx.edges, "v": ctx.n_nodes, "c": float(sr["c"]),
    }


def unit(state, rec):
    exact = importlib.import_module("graphtpu_torch.simrank.exact")
    spmv_mode, dtype = state["mode"]
    times = stages.Counted() if state["stage_times"] and rec["index"] >= 0 else None
    sim = exact.exact_simrank_spmm(state["g"], state["cfg"], spmv_mode=spmv_mode, dtype=dtype,
                                   device=state["device"], stage_times=times)
    vals, idx = exact.simrank_topk(sim, state["k"])
    if times is not None:
        stages.keep_counts(rec, times)
    return vals, idx


def judge(state, kept):
    state.pop("g")
    judged, _ = check.judge_simrank(state["edges"], state["v"], state["c"],
                                    state["cfg"].iterations, state["k"], state["device"],
                                    [(vals, idx, 0) for vals, idx in kept])
    return judged


def numbers(state, units):
    return stages.iterations_short(units, state["cfg"].iterations)


def release(state):
    state.clear()
