"""Runner of a CLI mix: ``graphtpu_torch.cli.main(argv)``, file in, files out.

Set-up writes the seed's edge list once (``src dst`` lines) under the
run's temporary directory.  One unit is one CLI job over the mix's
``argv``, whose ``{edges}``, ``{output}``, ``{mode}``, ``{iterations}``,
``{c}``, ``{topk}``, ``{n_nodes}`` and ``{device}`` are filled in; each job
overwrites the same two output files.  The jobs whose index the seed draws
(``KEEP`` of the first ``KEEP_FROM``) have their files moved aside, and
those and the window's last job's files are read back and judged against
the float64 SimRank of the configuration after the mix's iterations.  In the
traced run the CLI's call of ``exact_simrank_spmm`` is handed a
``stage_times``, which counts its product stages: a job that ran fewer
than the mix's iterations reads ``iterations_short`` above 0.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os

import numpy as np

from benchmark import check, stages
from benchmark.precision import MODES

KEEP, KEEP_FROM = 2, 3  # jobs whose files are kept: KEEP of the first KEEP_FROM


def setup(ctx):
    if ctx.mode not in MODES:
        raise ValueError(f"unknown precision {ctx.mode!r}")
    edges_path = os.path.join(ctx.tmpdir, "edges.txt")
    with open(edges_path, "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in ctx.edges.tolist()))
        f.write("\n")
    out = os.path.join(ctx.tmpdir, "out.txt")
    sr = ctx.config["simrank"]
    fill = {"edges": edges_path, "output": out, "mode": ctx.mode,
            "iterations": ctx.traffic["iterations"], "c": sr["c"], "topk": sr["topk"],
            "n_nodes": ctx.n_nodes,
            "device": "cuda" if ctx.device.type == "cuda" else ctx.device.type}
    rng = np.random.default_rng([ctx.seed, 1])
    keep = rng.choice(KEEP_FROM, KEEP, replace=False)
    return {"argv": [a.format(**fill) for a in ctx.traffic["argv"]], "out": out,
            "keep": {int(i) for i in keep}, "tmpdir": ctx.tmpdir, "v": ctx.n_nodes,
            "k": int(sr["topk"]), "last": None, "iterations": int(ctx.traffic["iterations"]),
            "stage_times": ctx.trace, "edges": ctx.edges, "c": float(sr["c"]),
            "device": ctx.device}


@contextlib.contextmanager
def _counted(times):
    """The program's ``exact_simrank_spmm``, as the CLI finds it, handed
    ``times`` as its ``stage_times`` while entered."""
    exact = importlib.import_module("graphtpu_torch.simrank.exact")
    orig = exact.exact_simrank_spmm

    def counted(*args, **kw):
        return orig(*args, stage_times=times, **kw)

    exact.exact_simrank_spmm = counted
    try:
        yield
    finally:
        exact.exact_simrank_spmm = orig


def unit(state, rec):
    from graphtpu_torch import cli

    times = stages.Counted() if state["stage_times"] and rec["index"] >= 0 else None
    with _counted(times) if times is not None else contextlib.nullcontext(), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(state["argv"])
    if times is not None:
        stages.keep_counts(rec, times)
    if rc != 0:
        raise RuntimeError(f"cli job {rec['index']} returned {rc}")
    out = state["out"]
    if rec["index"] in state["keep"]:
        kept = os.path.join(state["tmpdir"], f"kept{rec['index']}.txt")
        os.replace(out, kept)
        os.replace(out + ".sim.txt", kept + ".sim.txt")
        state["last"] = None
        return kept
    state["last"] = out if rec["index"] >= 0 else None
    return None


def judge(state, kept):
    paths = list(kept) + ([state["last"]] if state["last"] else [])
    answers = [check.read_topk_files(p, p + ".sim.txt", state["v"], state["k"]) for p in paths]
    judged, _ = check.judge_simrank(state["edges"], state["v"], state["c"], state["iterations"],
                                    state["k"], state["device"], answers)
    return judged


def numbers(state, units):
    return stages.iterations_short(units, state["iterations"])


def release(state):
    pass
