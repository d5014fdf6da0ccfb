"""Time SGNS's step kernel pair SG1 (``models/sgns.py``) at the node2vec cell's shape.

    python -m graphtpu_torch.bench.sgns_probe [--rounds 3] [--out probe.json]

On one card: R-MAT at scale 14 (V = 16,384, hubs of ~4,000 neighbours,
the shape of the cell's Kronecker graph), 10 first-order walks of 80 nodes
from every node with an edge, compacted with gensim's ``sample`` 1e-3, and
one step's batch of B = 8,192 centers drawn as ``train_sgns`` draws it
(window 10: 2w = 20 slots; N = 5 shared negatives) over [V, 128] float32
tables.  SG1's gradients are first held to the plain version's
(:func:`~graphtpu_torch.models.sgns._sgns_grads_plain`, within
``GRAD_RTOL`` of the largest row element; counts equal) and two launches
to each other's bits.  Then, in turns for ``--rounds`` rounds, each the
median of 9 CUDA-event runs of a CUDA graph of 20 calls (:func:`replay_ms`,
as ``train_sgns`` replays its steps; the plain version, which reads
sizes back to the host, eagerly): SG1a alone (``coeffs``), the keys' stable
sort alone (``sort``), SG1b (``rows``: the sort and its launch), the whole
of SG1 (``sg1``), the path it replaces (``segment``:
``sgns_closed_form`` and two ``segment_rows_sum`` calls), the plain
version (``plain``) and the whole step (``step``: SG1 and the update).
The bound is :func:`graphtpu_torch.bench.bounds.sgns_step_work` at 3.35
TB/s; the memory rise is ``max_memory_allocated`` over the tables and the
batch.  No PyTorch call computes the same function, so there is no library
yardstick.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
from statistics import median

import torch

from graphtpu_torch.bench import bounds
from graphtpu_torch.bench.timing import card, cuda_ms
from graphtpu_torch.models import sgns

B, WINDOW, NEG, DIM = 8192, 10, 5, 128
# SG1 and the plain version add each row's terms in other orders (a warp
# tree for a dot product, chunks for a row), each within a few hundred
# float32 roundings (2^-24) of the row's largest terms
GRAD_RTOL = 1e-5


def cell_batch(dev, seed: int = 0):
    """(params, (centers, contexts, mask, negatives), V): tables drawn from
    ``seed`` and one step's batch at the cell's shape (see the module's
    docstring)."""
    from graphtpu_torch.bench.generators import rmat14_graph
    from graphtpu_torch.walks.walker import simulate_walks

    g = rmat14_graph(device=dev)
    v = g.n_nodes
    walks = simulate_walks(g, 10, 80, seed, device=dev)
    counts = sgns.corpus_counts(walks, v)
    neg_j, neg_q = sgns.build_negative_alias(counts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cwalks, _ = sgns.subsample_and_compact(walks, counts, 1e-3, gen)
    slots = torch.randperm(walks.numel(), generator=gen, device=dev, dtype=torch.int32)[:B]
    batch = sgns.draw_batch(cwalks, slots, WINDOW, neg_j, neg_q, (B, NEG), gen)
    params = tuple(0.3 * torch.randn((v, DIM), generator=gen, device=dev) for _ in range(2))
    return params, batch, v


def grads_differ(got, want) -> str:
    """'' where SG1's ((g0, g1), (c0, c1)) agree with the plain version's
    (the sums within GRAD_RTOL of each table's largest element, the
    counts equal), else what differs."""
    for name, a, b in zip(("g0", "g1"), got[0], want[0]):
        tol = GRAD_RTOL * float(b.abs().max())
        err = float((a - b).abs().max())
        if not err <= tol:
            return f"{name} differs by {err:.3e} (tolerance {tol:.3e})"
    for name, a, b in zip(("c0", "c1"), got[1], want[1]):
        if not torch.equal(a, b):
            return f"{name} differs"
    return ""


def replay_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms of one call of ``fn``, replayed from a CUDA graph of
    ``reps`` calls (:func:`~graphtpu_torch.bench.timing.cuda_ms` of the
    replay over ``reps``): the card's time, without the host's dispatch,
    as ``train_sgns`` replays its steps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return cuda_ms(graph.replay) / reps


def sg1_times(dev, rounds: int = 3) -> dict:
    """One result at the cell's shape (see the module's docstring)."""
    params, batch, v = cell_batch(dev)
    centers, contexts, mask, negs = batch
    want = sgns._sgns_grads_plain(params, *batch, v)
    got = sgns.sg1_grads(params, *batch, v)
    again = sgns.sg1_grads(params, *batch, v)
    torch.cuda.synchronize()
    fault = grads_differ(got, want)
    if fault:
        raise RuntimeError(f"SG1 differs from the plain version: {fault}")
    if not all(torch.equal(a, b) for x, y in zip(got, again) for a, b in zip(x, y)):
        raise RuntimeError("two launches of SG1 differ")
    abs_err = [float((a - b).abs().max()) for a, b in zip(got[0], want[0])]
    rel_err = max(e / float(b.abs().max()) for e, b in zip(abs_err, want[0]))
    g, dv, keys = sgns.sg1_coeffs(params, *batch, v)
    live = int((g != 0).sum())
    cases = {
        "coeffs": lambda: sgns.sg1_coeffs(params, *batch, v),
        "sort": lambda: torch.sort(keys, stable=True),
        "rows": lambda: sgns.sg1_rows(params[0], centers, g, dv, keys, contexts.shape[1], v),
        "sg1": lambda: sgns.sg1_grads(params, *batch, v),
        "segment": lambda: sgns._segment_grads(params, *batch, v),
        "step": lambda: sgns.sgns_step(params, *batch, 0.01, v),
        "plain": lambda: sgns._sgns_grads_plain(params, *batch, v),
    }
    runs = {key: [] for key in cases}
    for r in range(rounds):
        for key in (cases if r % 2 == 0 else reversed(cases)):
            # the plain version syncs with the host (unique_consecutive): eager
            timer = cuda_ms if key == "plain" else replay_ms
            runs[key].append(timer(cases[key]))
    rise = {}
    for key in ("sg1", "segment"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cases[key]()
        torch.cuda.synchronize()
        rise[key] = torch.cuda.max_memory_allocated() - base
    bound_ms, bound_by = bounds.bound(*bounds.sgns_step_work(v, DIM, B, 2 * WINDOW, NEG, live))
    ms = {key: median(x) for key, x in runs.items()}
    return dict(shape=dict(b=B, w2=2 * WINDOW, n=NEG, d=DIM, v=v), live_slots=live,
                max_abs_err=max(abs_err), max_rel_err=rel_err,
                max_row_items=int(want[1][1].max()), ms=ms, runs=runs,
                bound_ms=bound_ms, bound_by=bound_by, of_bound=bound_ms / ms["sg1"],
                rise_bytes=rise)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sgns_probe needs a CUDA device")
    res = {"card": card(), "sg1": sg1_times(torch.device("cuda"), args.rounds)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
