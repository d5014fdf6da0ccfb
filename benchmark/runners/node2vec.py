"""Runner of the node2vec job mix: ``graphtpu_torch.cli.main(["node2vec",
...])``, edge file in, ``.emb`` out, as a user runs the reference's
``main.py --input --output``.

Set-up refuses a program whose walks and SGNS keep no module counters
(``NODE2VEC_COUNTS``, ``SGNS_COUNTS``), then writes the seed's edge list
once (``src dst`` lines) under the run's temporary directory.  Every job
of a run runs the same argv with one ``--seed`` drawn from the run's seed,
so every job does the same work.  A job's record holds the program's own
stage times (``node2vec_pipeline``'s ``stage_times``: ``walks``, ``sgns``,
``write``, ms), the node count ``n_nodes`` and what it added to the two
counters, each ``n_<count>`` (``n_walks``, ``n_steps``, ...).

While a job runs, the runner keeps (and hands the program on unchanged)
the walks ``simulate_walks`` returned, the tables ``node2vec_pipeline``
returned, and one step of the program's SGNS (``SgnsSteps.step``: its
tables before and after, the batch it drew and its rate), the step
drawn from the run's seed among the epoch's first tenth (the rate near
alpha, so that a gradient's error shows above the tables' float32
rounding); each is copied to the host after the job.  The jobs whose
index the seed draws (``KEEP`` of the first ``KEEP_FROM``) and the
window's last job are judged, each against the plain reference
(``benchmark/reference/node2vec.py``) on the same edges:

* ``bad_hops``, ``bad_starts``: the walks' faults (``walk_faults``; a
  walk of another length than the configuration's counts in
  ``bad_starts``);
* ``hop_share_err``: the largest gap, over the three hop kinds, between
  the walks' share and the share the bias rule expects for the same
  states (``hop_shares``);
* ``step_err``: the kept step replayed in float64 (``sgns_step``), the
  largest gap of a table element's change, over its row's scale: the
  largest change the reference makes in that row, or the median of those
  over the rows it changes where that is larger;
* ``auc_gap``: how far the job's edge-reconstruction AUC lies from the
  reference trainer's (one run of ``train_epochs`` on the first judged
  job's walks, from the run's seed), either way, both by syn0's dot
  products over the same seeded 100,000 edges and as many non-adjacent
  pairs.  Either way, since this AUC falls as the epoch goes on (a job
  trained on a tenth of its steps reads higher): it holds the job to the
  reference's law, not to a floor of quality;
* ``emb_bad``: the ``.emb`` file read back by the program's ``read_emb``:
  rows whose label is not the non-isolated node's id in order or whose
  values are not syn0's at 6 dp, and 1 for a wrong header (every row where
  the file cannot be read);
* traced only, ``steps_short`` and ``hops_short``: the epoch's steps and
  the walks' hops less the fewest a job counted.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os

import numpy as np
import torch

from benchmark.reference import node2vec as reference

KEEP, KEEP_FROM = 2, 3  # jobs whose outputs are kept: KEEP of the first KEEP_FROM
AUC_PAIRS = 100_000


def _counters():
    walks = importlib.import_module("graphtpu_torch.walks.node2vec")
    sgns = importlib.import_module("graphtpu_torch.models.sgns")
    return getattr(walks, "NODE2VEC_COUNTS", None), getattr(sgns, "SGNS_COUNTS", None)


def setup(ctx):
    if None in _counters() or not hasattr(importlib.import_module(
            "graphtpu_torch.models.sgns"), "SgnsSteps"):
        raise SystemExit("the program's node2vec walks and SGNS keep no NODE2VEC_COUNTS and "
                         "SGNS_COUNTS (nor SgnsSteps): this cell cannot run it")
    if ctx.mode is not None:
        raise SystemExit(f"the node2vec runner runs the configuration's float32, not {ctx.mode!r}")
    cfg = ctx.config["node2vec"]
    edges_path = os.path.join(ctx.tmpdir, "edges.txt")
    with open(edges_path, "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in ctx.edges.tolist()))
        f.write("\n")
    out = os.path.join(ctx.tmpdir, "out.emb")
    e = np.asarray(ctx.edges, np.int64)
    n = int(e.max()) + 1  # the CLI's node count: the largest id + 1
    active = np.unique(e[e[:, 0] != e[:, 1]])
    slots = int(cfg["num_walks"]) * active.size * int(cfg["walk_length"])
    batch = min(int(cfg["batch"]), slots, max(64, n))  # train_sgns's batch at this size
    rng = np.random.default_rng([ctx.seed, 1])
    keep = rng.choice(KEEP_FROM, KEEP, replace=False)
    job_seed = int(rng.integers(1 << 31))
    steps = int(cfg["epochs"]) * (slots // batch)
    fill = {"edges": edges_path, "output": out, "seed": job_seed,
            "device": "cuda" if ctx.device.type == "cuda" else ctx.device.type,
            **{k: cfg[k] for k in ("dimensions", "walk_length", "num_walks", "window", "epochs",
                                   "p", "q", "sample")}}
    return {"argv": [a.format(**fill) for a in ctx.traffic["argv"]], "out": out,
            "keep": {int(i) for i in keep}, "tmpdir": ctx.tmpdir, "last": None,
            "step_index": int(rng.integers(1, max(2, slots // batch // 10))),
            "steps": steps, "hops": slots // int(cfg["walk_length"]) * (int(cfg["walk_length"]) - 1),
            "batch": batch, "n": n, "active": active, "edges": ctx.edges, "cfg": cfg,
            "seed": ctx.seed, "device": ctx.device, "trace": ctx.trace}


@contextlib.contextmanager
def _kept(job: dict, step_index: int):
    """The program's ``node2vec_pipeline``, ``simulate_walks`` (as the
    pipeline finds them) and ``SgnsSteps.step``, each handing its result on
    and keeping it in ``job`` while entered: the stage times and syn0, the
    walks, and the ``step_index``-th step's tables before and after, its
    batch and its rate (device clones)."""
    pipelines = importlib.import_module("graphtpu_torch.pipelines")
    sgns = importlib.import_module("graphtpu_torch.models.sgns")
    run, walk, step = pipelines.node2vec_pipeline, pipelines.simulate_walks, sgns.SgnsSteps.step
    calls = [0]

    def run_kept(*a, stage_times=None, **kw):
        job["syn0"] = run(*a, stage_times=stage_times, **kw)
        job["stage_times"] = dict(stage_times or {})
        return job["syn0"]

    def walk_kept(*a, **kw):
        job["walks"] = walk(*a, **kw)
        return job["walks"]

    def step_kept(self, params, slots, lr):
        calls[0] += 1
        if calls[0] - 1 != step_index:
            return step(self, params, slots, lr)
        before = tuple(p.clone() for p in params)
        out = step(self, params, slots, lr)
        centers, contexts, mask, negs = (t.clone() for t in self.batch)
        job["step"] = {"params": before, "centers": centers, "contexts": contexts, "mask": mask,
                       "negs": negs, "lr": float(lr), "out": tuple(p.clone() for p in out)}
        return out

    pipelines.node2vec_pipeline, pipelines.simulate_walks, sgns.SgnsSteps.step = (
        run_kept, walk_kept, step_kept)
    try:
        yield
    finally:
        pipelines.node2vec_pipeline, pipelines.simulate_walks, sgns.SgnsSteps.step = (
            run, walk, step)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(_host(t) for t in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def unit(state, rec):
    from graphtpu_torch import cli

    counters = _counters()
    before = [dict(c) for c in counters]
    job = {}
    with _kept(job, state["step_index"]), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(state["argv"])
    if rc != 0:
        raise RuntimeError(f"node2vec job {rec['index']} returned {rc}")
    counts = {k: float(c[k] - b.get(k, 0)) for c, b in zip(counters, before) for k in c}
    rec["counts"] = counts
    rec["stage_times"] = dict(job.get("stage_times", {}), n_nodes=float(state["n"]),
                              **{f"n_{k}": x for k, x in counts.items()})
    answer = {"walks": _host(job.get("walks")), "syn0": job.get("syn0"),
              "step": _host(job.get("step")), "counts": counts, "emb": state["out"]}
    job.clear()
    if rec["index"] in state["keep"]:
        kept = os.path.join(state["tmpdir"], f"kept{rec['index']}.emb")
        os.replace(state["out"], kept)
        state["last"] = None
        return dict(answer, emb=kept)
    state["last"] = answer if rec["index"] >= 0 else None
    return None


def _step_err(step, device) -> float:
    """The kept step's change of each table element against (b)'s, over
    the row's scale; inf where no step was kept."""
    if not step:
        return float("inf")
    dev = lambda t: t.to(device)  # noqa: E731
    old = tuple(dev(p) for p in step["params"])
    ref = reference.sgns_step(*old, dev(step["centers"]), dev(step["contexts"]),
                              dev(step["mask"]), dev(step["negs"]), step["lr"])
    worst = 0.0
    for was, got, want in zip(old, step["out"], ref):
        d_want = want - was.double()
        d_got = dev(got).double() - was.double()
        top = d_want.abs().amax(1)
        moved = top > 0
        floor = top[moved].median() if moved.any() else torch.ones((), dtype=top.dtype,
                                                                    device=top.device)
        worst = max(worst, float(((d_got - d_want).abs().amax(1) / top.clamp(min=floor)).max()))
    return worst


def _emb_bad(path: str, syn0: np.ndarray, active: np.ndarray, dim: int) -> float:
    from graphtpu_torch.io.embfile import read_emb

    try:
        with open(path) as f:
            header = f.readline().split()
        labels, vecs = read_emb(path)
    except (OSError, ValueError, IndexError):
        return float(active.size)
    want = (np.rint(syn0[active].astype(np.float64) * 1e6) / 1e6).astype(np.float32)
    if vecs.shape != want.shape:
        return float(active.size)
    rows = (np.array(labels) != active.astype(str)) | (vecs != want).any(1)
    return float(rows.sum() + (header != [str(active.size), str(dim)]))


def judge(state, kept):
    cfg, dev = state["cfg"], state["device"]
    answers = list(kept) + ([state["last"]] if state["last"] else [])
    if not answers:
        return []
    adj = reference.adjacency(state["edges"], state["n"], dev)
    pos, neg = reference.auc_pairs(adj, AUC_PAIRS, state["seed"] % (1 << 63))
    first = answers[0]["walks"]
    ref_auc = None
    if first is not None:
        ref_syn0 = reference.train_epochs(
            first.to(dev), state["n"], int(cfg["dimensions"]), int(cfg["window"]),
            int(cfg["negative"]), float(cfg["sample"]), float(cfg["alpha"]),
            float(cfg["min_alpha"]), state["batch"], int(cfg["epochs"]),
            state["seed"] % (1 << 63))
        ref_auc = reference.edge_auc(ref_syn0, pos, neg)
        del ref_syn0
    out = []
    for ans in answers:
        nums = {"bad_hops": float("inf"), "bad_starts": float("inf"),
                "hop_share_err": float("inf"), "auc_gap": float("inf")}
        if ans["walks"] is not None:
            walks = ans["walks"].to(dev)
            nums.update(reference.walk_faults(walks, adj, int(cfg["num_walks"])))
            if walks.shape[1] != int(cfg["walk_length"]):
                nums["bad_starts"] += walks.shape[0]
            got, want = reference.hop_shares(walks, adj, float(cfg["p"]), float(cfg["q"]))
            nums["hop_share_err"] = float((got - want).abs().max())
            del walks
        if ans["syn0"] is not None and ref_auc is not None:
            emb = torch.as_tensor(ans["syn0"], device=dev)
            nums["auc_gap"] = abs(ref_auc - reference.edge_auc(emb, pos, neg))
        nums["step_err"] = _step_err(ans["step"], dev)
        nums["emb_bad"] = (float(state["active"].size) if ans["syn0"] is None else
                           _emb_bad(ans["emb"], ans["syn0"], state["active"],
                                    int(cfg["dimensions"])))
        out.append(nums)
    return out


def numbers(state, units):
    counted = [u["counts"] for u in units if u["index"] >= 0 and "counts" in u]
    if not state["trace"] or not counted:
        return {}
    return {"steps_short": float(state["steps"] - min(c.get("steps", 0) for c in counted)),
            "hops_short": float(state["hops"] - min(c.get("hops", 0) for c in counted))}


def release(state):
    state.clear()
