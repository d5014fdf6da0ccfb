#!/usr/bin/env python3
"""Drive graphtpu_torch's paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py [--out report.json]

Phases (any failure raises and the run exits non-zero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the hand kernels from graphtpu_torch/kernels/csrc, and
     the C++ parser and generator from graphtpu_torch/native.
  3. kernels: kernels B1 (Kahan) and B2 (fast) against their plain PyTorch
     version and the float64 oracle on the blog-shaped stream (V = C =
     10,496, the column-panel design), plus seg-2 (row tiles), ragged and
     bf16 cases, a V = 60,000 case (the L2 column tiles) and the Kahan hub
     at degree 20,000 (row tiles) and 11,000 (the panel): B1, and B2 in the
     panel, within 1e-5, while a sequential f32 sum must miss; every case
     launched twice and the outputs held bit-equal; CUDA-event times of
     kernel, plain version and one torch.sparse.mm.  Then R-MAT 14 (the
     packed-lane panel) and the arxiv shape (V = 38,912, the L2 column
     tiles in f32, 16-byte row tiles in bf16) at C = V: B1 and B2 in f32
     and B2 in bf16, each with and without the pin, against the plain
     version and the float64 oracle, and bit-equal to the row tiles on rows
     of at most SELL_HUB items; kernel, row-tile, plain and torch.sparse.mm
     times beside the bound.
  4. tree kernel: kernel B3 against its plain version on every level of
     the blog-shaped and R-MAT reduction trees at 4,096-column blocks
     (level 0 read in place from the wider iterate), the ragged tail
     block, C = 10,313, a bf16 table and the weighted blog tree's level 0;
     each level in every design tree_spmm can launch on it (blog level 0:
     row tiles, and the panel, which stores slab-major; level 1: row tiles
     reading rows and reading level 0's slabs), each bit-equal to the
     plain version, with each level's time and bound; one embedding_bag
     beside level 0; the whole tree product against the float64 oracle
     and, f32 and bf16, bit-equal to the row tiles alone
     (``dataclasses.replace(tree, layouts=())``).
  5. main path: ``python -m graphtpu_torch simrank --engine spmm`` for
     modes kahan, fast and fast16 on the blog-shaped graph; launch counts,
     files read back, scores against the dense fp32 engine, the host ms of
     the sliced layout.
  6. skew: the kahan run again on an R-MAT graph (V = 16,384, the packed-
     lane panel), its in-process call held within 1e-6 of the same call on
     forced row tiles.
 6b. the arxiv shape: ``simrank --engine spmm`` on the arxiv-shaped edge
     file (V = 38,912, the L2 column tiles), kahan and fast, 3 iterations;
     launch counts, the file's top-20 scores against the in-process call's,
     which is held within 1e-6 of the same call on forced row tiles; stage
     times and peak memory of both.
  7. tree path: ``exact_simrank_spmm(impl="tree")`` on the blog-shaped
     graph (f32, bf16) and R-MAT (f32); B3 launch counts, scores against
     the dense fp32 engine, per-stage times, the compact plans' host ms and
     peak memory.
  8. rate probe: ``python -m graphtpu_torch.bench.spmv_rate`` on both
     graphs (ns per item of B1, B2, X1-X3; X1-X3 on B2's panel at blog,
     each beside B2, and B2 - X2 as the panel's share; X2 over R-MAT's
     sliced layout, which reads no panel, in ns per chunk and slab beside
     blog's, held against its plain version and the row tiles), then X1-X3 against
     their plain versions, at blog also in row tiles (X1's outputs
     bit-equal, X2's and X3's on lane rows), each beside one PyTorch
     library call at blog (X1 a max embedding_bag, X2 a weighted sum bag,
     X3 a ones-CSR torch.sparse.mm), checked once against the plain version.
  9. walks (blog-shaped graph, its device edge set a bitmap; the V = 60,000
     graph, a cuckoo set): every transition of ``simulate_walks`` an edge
     (``edge_exists`` on the card) at p = q = 1 and p = 1, q = 2; next-hop
     frequencies of both second-order modes within TV 0.02 of
     ``node2vec_transition_probs`` over 200,000 draws at three (p, q);
     hop rates (M hops/s, CUDA events and host clock, and the share of the
     host clock the card was busy, from the profiler's kernel intervals)
     at bench.py's shapes; one node2vec hop split into its row reads,
     proposals, edge-set probes and panel arithmetic.
 10. SGNS on the blog walks at full width: ms per step (B = 8192, W = 10,
     N = 5, D = 128) and peak memory; two runs bit-equal; a run resumed
     from a mid-run checkpoint bit-equal to the uninterrupted one; the
     two-clique quality check.
 11. ``python -m graphtpu_torch node2vec --p 1 --q 2`` at the reference
     defaults in a subprocess (no --device): the .emb read back (V' rows
     of 128 finite values) and its wall time split into walks, SGNS and the
     file write.
 12. the Monte-Carlo engines on the card: the reuse top-k (sort-based)
     against the dense scatter on the same walks at blog width within 1e-5;
     TopSim full enumeration on the card against the CPU within 1e-6; two
     UniWalk runs with one seed on 256 blog sources bit-equal; top-20
     precision and NDCG of UniWalk and TopSim (sample 10,000, step 3) on
     R-MAT scale 11 against exact SimRank, each at least graphtpu's figure
     less 0.03; the flagship's shape (SAMPLE 10,000, TIMES 4, STEP 5) over
     1,024 blog sources in two windows of 512, stopped after the first and
     resumed, every source once; a UniWalk tile's hop and item rates at the
     CLI defaults with its parts, busy share and peak memory; a TopSim
     tile's time, busy share and peak memory.
 13. ``python -m graphtpu_torch uniwalk`` and ``topsim`` at the defaults on
     the blog-shaped edge file in subprocesses (walls split into read,
     engine and write; one row per node in both twin files, valid ids,
     finite positive descending scores, no dropped mass), then ``sweep
     --algorithm uniwalk --samples 1000 10000`` on R-MAT scale 11 (the
     second precision at least the first less 0.02).
 14. DeepSim on the blog-shaped edge file: ``python -m graphtpu_torch
     simrank --engine spmm --mode kahan --iterations 3 --c 0.6 --topk 20``
     (kernel B1; its launches as the subprocess prints them, its top-20
     file against the dense float32 engine at V = 10,240) and ``deepsim
     --steps 2000`` at the reference's widths in subprocesses (no --device):
     the .emb read back (V rows of 128 finite values), the wall split into
     read, walks, train and write; in process ``lookup_sim`` on the card
     against a dictionary over 10,000 pairs, exactly, ``train_deepsim``'s
     wall per step over 2,000 steps with the mean loss of the last 100
     below that of the first 100, ``Trainer.step``'s time (CUDA events and
     host clock), device intervals, busy share and peak memory, and two
     seeded 200-step runs bit-equal.
 15. SDNE: the reference net [784, 400, 100, 300, 784] on the card against a
     float64 numpy oracle of the reference's formulas (activations within
     2e-4 of max(1, |ref|), loss terms at 1e-4, KL at 1e-3); the step at the
     blog shape (time, peak memory) and ``train_sdne``'s wall per step;
     ``sdne`` at its defaults on the blog edge file in a subprocess, the
     .emb read back.
 16. Laplacian Eigenmaps: ``le`` on the swiss roll (2,000 points, k = 10,
     t = 15), on the blog .sim.txt and on R-MAT scale 11's (written by the
     simrank CLI, kernel B1, held as in 14), in
     subprocesses: every kept eigenpair's residual in float64 below 1e-3,
     every kept eigenvalue above 1e-5, the wall and the ``eigh`` alone; at
     R-MAT 11 the card's float32 spectrum against scipy's float64 ``eigh``
     within 1e-4.
 17. support modules: BFS distances from 64 blog sources on the card equal
     scipy's unweighted shortest paths; on that card-resident graph,
     ``neighbors``/``degree`` of a few nodes equal to its CSR,
     ``bfs_order(start=hub)`` a permutation that visits the hub's component
     in BFS layers, and ``locality_score(window=2)`` equal to the count
     made on the card; the weight sums and variances of a
     weighted blog graph within 1e-6 of numpy float64 and bit-equal run to
     run; the C++ parser's read of the blog edge file equal to the numpy
     reader's, both timed; ``generate --kind massive`` (the C++ generator)
     writing 2,000,000 distinct in-range bipartite edges; and
     ``load_graph_cached``'s second touch equal to its first, both timed.
 18. dist (blog-shaped graph, 3 iterations): 4 gloo ranks sharing the card,
     then 1 NCCL rank, each running the 1-D ring (f32, bf16), SUMMA (2x2;
     1x1 on one rank) and the dense form, every rank's block against the
     single-device tree path (dense: the dense engine) on its device within
     1e-6 (bf16: 4 bf16 ulps of the tree path's bf16 run); B3 launched in
     every rank; B3 on each rank's local tree (ring f32, bf16; SUMMA) over
     the first block it multiplies and a seeded block of that shape and
     dtype within 1e-6 of its plain version; per iteration the time split into B3, the wire and the
     transposes, the plan's ms and peak memory per rank; node2vec walks
     (40,960 x 10 hops, p = 1, q = 2) every transition an edge; reuse
     UniWalk on 1,024 sources' injected walks and TopSim on 1,024 sources
     in the even-split regime, each within 1e-5 of the single-device
     engine; one ``train_sgns_dp`` epoch within 1e-5 of ``train_sgns``.
 19. the 10M flagship (``graphtpu_torch/bench/flagship.py``: V =
     10,000,000, average degree 8, SAMPLE 10,000, TIMES 4, STEP 5, tiles of
     2,048, windows of 4,096): generate, load (parse and CSR, then the
     cached CSR), two windows stopped by the window budget, a resumed run
     for the third; every source once; each row of the part files the
     float top-k the run computed (ids equal, scores within the 6-decimal
     rounding, every kept score above 0), empty just where the source has
     no edge; s per tile, G hops/s, peak memory.  Then SGNS's model axis
     at that V: 4 gloo ranks sharing the card as a (1, 4) mesh run 10 steps
     of ``make_sgns_train_step`` (B = 8,192, D = 128, shared negatives) on
     batches from 65,536 uniform walks of 20 hops; every rank's tables are
     its two 2,500,000-row shards and its peak stays below one whole table;
     8,192 sampled touched and 8,192 untouched rows within 1e-5 of the same
     steps of ``sgns_step`` on whole tables on the card (untouched rows
     unchanged); ms per step split into lookup, compute and update.
     Phase 18 also runs its SGNS epoch on (4, 1), (2, 2) and (1, 4)
     (data, model) meshes, each within 1e-5 of one card, with the split,
     the tables, peak and all-reduce bytes per rank.
 20. dense precision: ``exact_simrank`` at blog, 5 iterations, at
     matmul_precision "highest", "high" (bit-equal to "highest") and
     "default" (TF32: differs from "highest", by at most 2·5·2^-11); each
     mode's time and "default"'s top-20 agreement with "highest".
Phases 9-20 print their numbers as a ``{"paths": ...}`` line (12-13 under
``mc``).
The last two lines are the kernels' JSON summary (with each kernel's bound
from graphtpu_torch/bench/bounds.py; B3's level-0 time excludes the cost its
slab-major output moves to level 1, so its entry also gives levels 0 + 1
and the whole product, each against the row tiles alone, and R-MAT 14's
levels on row tiles; B1/B2 name the design of each shape) and the JSON
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from graphtpu_torch.bench.generators import (
    ARXIV_NODES,
    BLOG_NODES,
    RMAT14_NODES,
    V60000_NODES,
    arxiv_shaped_edges,
    arxiv_shaped_graph,
    blog_shaped_edges,
    blog_shaped_graph,
    rmat14_edges,
    rmat14_graph,
    v60000_graph,
)
from graphtpu_torch.bench.timing import busy_ms, cuda_ms, device_profile, stream_csr
from graphtpu_torch.bench.timing import card as card_line

TOL_F32 = 1e-5        # f32 product vs plain version / float64 oracle, values <= 1
TOL_B3 = 1e-6         # B3 vs its plain version (same operations: bit-equal expected)
TOL_RATE = 1e-5       # X2/X3 vs plain, relative to the row's sum of |terms|
TOL_SIM_F32 = 2e-5    # SimRank scores, f32 modes, vs the dense fp32 engine
TOL_SIM_BF16 = 1e-2   # SimRank scores, fast16, vs the dense fp32 engine
TOL_MC_PARITY = 1e-5  # reuse top-k (sort, float64 run totals) vs the dense scatter oracle
TOL_MC_ENUM = 1e-6    # TopSim enumerate, card vs CPU (the same float32 operations)
TOL_F32_DIST = 1e-6   # sharded f32 SimRank vs the single-device tree path / dense engine
TOL_DESIGNS = 1e-6    # f32 SimRank on the stream's design vs forced row tiles
# B1/B2's design at phase 3's shapes: (f32 tables, bf16 tables)
DESIGNS_LARGE = {"rmat": ("packed", "packed"), "arxiv": ("tiles", "rows")}
TOL_SDNE_ACT = 2e-4   # SDNE activations vs the float64 oracle, of max(1, |ref|)
TOL_LE_RESIDUAL = 1e-3  # LE: ||(D - W)y - lambda D y|| / ||D y|| of each kept pair, float64
TOL_LE_EIGH = 1e-4    # LE: the float32 spectrum on the card vs scipy's float64 eigh
TOL_STATS = 1e-6      # weight sums and variances vs numpy float64, of the largest
DEEPSIM_STEPS = 2000  # the smoke's DeepSim run (the CLI's default is the reference's 50,000)
SDNE_STEPS = 500      # train_sdne timed in process (the CLI runs its default 2,000)
MASSIVE = (200_000, 200_000, 10)  # generate --kind massive: left, right, average degree
# graphtpu's top-20 precision and NDCG on R-MAT scale 11 (V = 2,048, all
# sources; the gold is dense fp32 SimRank, 30 iterations, top 1,000), from
# graphtpu.bench.sweep's sweep_uniwalk and sweep_topsim at sample 10,000,
# step 3 and their default tiles and keys, run by graphtpu on a CPU
GRAPHTPU_RMAT11 = {
    "uniwalk": {"precision": 0.9744140625000025, "ndcg": 1.0188382310640378},
    "topsim": {"precision": 0.9762939453125024, "ndcg": 1.0088449591525102},
}
QUALITY_MARGIN = 0.03  # the port's figures may fall this far below graphtpu's
C_RAGGED = 10_313
HUB_DEGREES = (20_000, 11_000)  # row tiles; the column panel (V <= 11,448)
V_PANELS, C_PANELS = V60000_NODES, 256  # a V past one block's shared memory
ORACLE_ROWS = 384     # rows of each product held against the float64 oracle
COL_BLOCK = 4096      # exact_simrank_spmm's tree column block
ITERATIONS = 3
SOURCE = "graphtpu_torch/kernels/csrc/spmv.cu"
RATE_SOURCE = "graphtpu_torch/kernels/csrc/spmv_rate.cu"
REPLACES = {
    "kahan": "graphtpu/kernels/spmm.py:391",  # _spmv_kernel (B1)
    "fast": "graphtpu/kernels/spmm.py:542",   # _spmv_kernel_fast (B2)
}
RATE_KERNELS = (  # launch-count key, label, TPU kernel
    ("gather_only", "rate_gather_only (X1)", "tools/exp_spmv_rate.py:29"),
    ("accumulate_only", "rate_accumulate_only (X2)", "tools/exp_spmv_rate.py:71"),
    ("unroll8", "rate_unroll8 (X3)", "tools/exp_spmv_rate.py:122"),
)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each entry's magnitude (0 for zeros)."""
    _, e = torch.frexp(a.double().abs())
    return torch.where(a != 0, torch.ldexp(torch.ones_like(a, dtype=torch.float64), e - 8), 0.0)


def pinned64(x: np.ndarray, c: float) -> np.ndarray:
    """float64 where(col == row, 1, c·x)."""
    t = c * x.astype(np.float64)
    n = min(t.shape)
    t[np.arange(n), np.arange(n)] = 1.0
    return t


def library_ms(fn):
    """CUDA-event time of one PyTorch call, or None where it does not run."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        say(f"  library call not available: {str(e).splitlines()[0][:120]}")
        return None
    return cuda_ms(fn)


def phase_kernels(dev, report):
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.reorder import rcm_order, relabel_graph
    from graphtpu_torch.kernels import spmm

    g = blog_shaped_graph()
    g2, _ = relabel_graph(g, rcm_order(g))
    plan = spmm.build_spmv_stream(g, device=dev)
    seg2 = spmm.build_spmv_segments(g2, k=2, device=dev)
    say(f"blog stream: V={g.n_nodes} slots={g.n_edges} items={plan.n_items} "
        f"max_degree={g.max_degree}; sliced layout: {plan.sell.n_chunks} chunks, "
        f"{plan.sell.hub_rows.numel()} hub rows, built in {plan.sell.host_ms:.1f} ms "
        f"(host); rcm seg-2 stream: items={seg2.n_items}")
    x_np = np.random.default_rng(1).random((BLOG_NODES, BLOG_NODES), dtype=np.float32)
    x = torch.from_numpy(x_np).to(dev)
    xb = x.bfloat16()
    xb_np = xb.float().cpu().numpy()
    x64 = {(False, "f32"): x_np, (True, "f32"): pinned64(x_np, 0.6),
           (False, "bf16"): xb_np, (True, "bf16"): pinned64(xb_np, 0.6)}
    rng = np.random.default_rng(2)
    deg = g.host[3]
    special = [int(np.argmax(deg)), int(np.argmax(g2.host[3])), BLOG_NODES - 1, 0]
    rows = np.unique(np.concatenate([rng.choice(BLOG_NODES, ORACLE_ROWS), special]))

    # past one panel: row tiles
    gp = v60000_graph()
    plan_p = spmm.build_spmv_stream(gp, device=dev)
    xp_np = np.random.default_rng(4).random((V_PANELS, C_PANELS), dtype=np.float32)
    xp = torch.from_numpy(xp_np).to(dev)
    rows_p = np.unique(np.concatenate(
        [np.random.default_rng(5).choice(V_PANELS, ORACLE_ROWS), [7, 0, V_PANELS - 1]]))

    blog = lambda t, ts: x64[(ts is not None, "bf16" if t.dtype == torch.bfloat16 else "f32")]
    cases = [
        # name, mode, plan, graph, table, table_scale, float64 table, rows
        ("kahan_f32", "kahan", plan, g, x, None, blog, rows),
        ("kahan_f32_pin", "kahan", plan, g, x, 0.6, blog, rows),
        ("fast_f32", "fast", plan, g, x, None, blog, rows),
        ("fast_f32_pin", "fast", plan, g, x, 0.6, blog, rows),
        ("fast_bf16_pin", "fast", plan, g, xb, 0.6, blog, rows),
        ("fast_bf16", "fast", plan, g, xb, None, blog, rows),
        ("kahan_seg2_rcm_pin", "kahan", seg2, g2, x, 0.6, blog, rows),
        ("fast_seg2_rcm_pin", "fast", seg2, g2, x, 0.6, blog, rows),
        ("kahan_f32_pin_ragged", "kahan", plan, g, x[:, :C_RAGGED].contiguous(), 0.6,
         blog, rows),
        ("fast_bf16_pin_ragged", "fast", plan, g, xb[:, :C_RAGGED].contiguous(), 0.6,
         blog, rows),
    ]
    p64 = lambda t, ts: pinned64(xp_np, 0.6)
    for mode in ("kahan", "fast"):
        cases.append((f"{mode}_v{V_PANELS}_pin", mode, plan_p, gp, xp, 0.6, p64, rows_p))
    results = []
    for name, mode, p, gg, table, ts, ref64, orows in cases:
        bf = table.dtype == torch.bfloat16
        out = spmm.spmv(p, table, mode, ts)
        torch.cuda.synchronize()
        plain = spmm.spmv_plain(p, table, mode, ts)
        check(out.shape == (gg.n_nodes + 1, table.shape[1]) and out.dtype == table.dtype,
              f"{name}: shape/dtype {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
        again = spmm.spmv(p, table, mode, ts)
        check(torch.equal(out, again), f"{name}: two launches differ")
        del again
        err_plain = (out.float() - plain.float()).abs().max().item()
        oracle = spmm.spmm_oracle(gg, ref64(table, ts)[:, : table.shape[1]], rows=orows)
        got_rows = out[torch.as_tensor(orows, device=dev)].float().cpu().numpy()
        err_oracle = float(np.abs(got_rows - oracle).max())
        if bf:
            within_plain = bool(
                ((out.float() - plain.float()).abs()
                 <= bf16_ulp(torch.maximum(out.float().abs(), plain.float().abs()))).all())
            o = torch.from_numpy(oracle)
            within_oracle = bool(((torch.from_numpy(got_rows).double() - o).abs() <= bf16_ulp(o)).all())
            bound = "1 bf16 ulp relative"
        else:
            within_plain = err_plain <= TOL_F32
            within_oracle = err_oracle <= TOL_F32
            bound = f"{TOL_F32:g} absolute"
        used = spmm.spmv_design(p, table.dtype)
        ms = cuda_ms(lambda: spmm.spmv(p, table, mode, ts))
        plain_ms = cuda_ms(lambda: spmm.spmv_plain(p, table, mode, ts), warmup=1, runs=5)
        lib_ms = None
        if ts is None and p is plan and name in ("kahan_f32", "fast_f32", "fast_bf16"):
            # one PyTorch call of the same product: the folded P as CSR
            csr = stream_csr(p, p.wts).to(table.dtype)
            lib_ms = library_ms(lambda: torch.sparse.mm(csr, table))
            del csr
        r = dict(case=name, kernel=mode, design=used, items=p.n_items, seg_k=p.seg_k,
                 width=int(table.shape[1]), dtype=str(table.dtype).split(".")[-1],
                 max_abs_err_plain=err_plain, max_abs_err_oracle=err_oracle,
                 oracle_rows=int(len(orows)), bound=bound, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms)
        results.append(r)
        say(f"{name} ({used}): err vs plain {err_plain:.3e}, vs float64 oracle "
            f"{err_oracle:.3e} ({len(orows)} rows), bound {bound}; two launches equal; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            + ("" if lib_ms is None else f", torch.sparse.mm {lib_ms:.3f} ms"))
        check(within_plain, f"{name}: kernel vs plain version outside {bound}")
        check(within_oracle, f"{name}: kernel vs float64 oracle outside {bound}")
        del out, plain

    # Kahan hub: one row of degree d whose neighbours hold equal values in
    # each column, so every f32 partial sum rounds the same way; its plain
    # version is itself a plain f32 sum, which this case is built to
    # defeat, so it is reported only
    hubs = []
    for d in HUB_DEGREES:
        star = np.stack([np.zeros(d, np.int64), np.arange(1, d + 1)], 1)
        hub_g = build_graph(star, n_nodes=d + 1)
        hub_vals = (1 + np.random.default_rng(3).random(1024)).astype(np.float32)
        hub_np = np.broadcast_to(hub_vals, (d + 1, 1024)).copy()
        hub_x = torch.from_numpy(hub_np).to(dev)
        hub_plan = spmm.build_spmv_stream(hub_g, device=dev)
        design = spmm.spmv_design(hub_plan)
        hub_oracle = spmm.spmm_oracle(hub_g, hub_np, rows=[0])[0]
        lo, hi = hub_plan.row_items[:2].tolist()
        terms = (hub_plan.wts[lo:hi].cpu().numpy()[:, None]
                 * hub_np[hub_plan.slots[lo:hi].long().cpu().numpy()]).astype(np.float32)
        seq = np.cumsum(terms, axis=0, dtype=np.float32)[-1]
        err = lambda o: float(np.abs(o[0].float().cpu().numpy() - hub_oracle).max())
        hub = dict(case="kahan_hub", degree=d, design=design,
                   kahan_err_oracle=err(spmm.spmv(hub_plan, hub_x, "kahan")),
                   fast_err_oracle=err(spmm.spmv(hub_plan, hub_x, "fast")),
                   sequential_f32_err_oracle=float(np.abs(seq - hub_oracle).max()),
                   plain_err_oracle=err(spmm.spmv_plain(hub_plan, hub_x, "kahan")))
        say(f"kahan_hub (degree {d}, {design}): vs float64 oracle: B1 "
            f"{hub['kahan_err_oracle']:.3e}, B2 {hub['fast_err_oracle']:.3e}, sequential f32 "
            f"sum {hub['sequential_f32_err_oracle']:.3e}, plain version "
            f"{hub['plain_err_oracle']:.3e}; bound {TOL_F32:g}")
        check(hub["kahan_err_oracle"] <= TOL_F32, f"kahan_hub {d}: B1 outside the bound")
        if design == "panel":
            check(hub["fast_err_oracle"] <= TOL_F32, f"kahan_hub {d}: B2 outside the bound")
        check(hub["sequential_f32_err_oracle"] > TOL_F32,
              f"kahan_hub {d}: a sequential f32 sum met the bound, so the case separates nothing")
        hubs.append(hub)
        del hub_x
    report["kernel_cases"] = results
    report["kahan_hub"] = hubs
    del x, xb, xp
    torch.cuda.empty_cache()
    return results, plan.n_items


class HostRows:
    """The rows of a card-resident table in float64 on the host, fetched
    on demand (the float64 oracle reads few of them) and, with ``c``,
    pinned: where(col == row, 1, c·x)."""

    def __init__(self, table, c):
        self.table, self.c, self.shape = table, c, tuple(table.shape)

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        r = self.table[torch.as_tensor(idx, device=self.table.device)].double().cpu().numpy()
        if self.c is not None:
            r = self.c * r
            hit = np.flatnonzero(idx < r.shape[1])
            r[hit, idx[hit]] = 1.0
        return r


def phase_kernels_large(dev, report):
    """B1 and B2 at C = V on R-MAT 14 and the arxiv shape, in the design the
    stream gets (``spmm.spmv_design``): f32 with and without the pin, B2 in
    bf16 with and without it; each against its plain version, the float64
    oracle on ORACLE_ROWS rows and the row tiles (``spmm.row_tiles``),
    bit-equal to them on rows of at most SELL_HUB items; kernel, row-tile,
    plain and (unpinned) ``torch.sparse.mm`` times and the bound."""
    from graphtpu_torch.bench import bounds
    from graphtpu_torch.kernels import spmm

    results = []
    for tag, make in (("rmat", rmat14_graph), ("arxiv", arxiv_shaped_graph)):
        g = make()
        plan = spmm.build_spmv_stream(g, device=dev)
        rows_plan = spmm.row_tiles(plan)
        v = g.n_nodes
        cnt = torch.diff(plan.row_items)
        lane = cnt <= spmm.SELL_HUB
        deg = g.host[3]
        orows = np.unique(np.concatenate([
            np.random.default_rng(7).choice(v, ORACLE_ROWS), [int(np.argmax(deg)), 0, v - 1]]))
        say(f"{tag} stream: V={v} slots={g.n_edges} items={plan.n_items} max_degree="
            f"{g.max_degree}; hub rows hold {spmm.hub_share(plan):.3f} of the items; "
            f"f32 design {spmm.spmv_design(plan)}"
            + ("" if plan.tiles is None else
               f" ({plan.tiles.n_pieces} hub pieces, plan {plan.tiles.host_ms:.1f} ms host)"))
        x = torch.rand((v, v), generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        for name, mode, dtype, ts in (("kahan_f32", "kahan", torch.float32, None),
                                      ("kahan_f32_pin", "kahan", torch.float32, 0.6),
                                      ("fast_f32", "fast", torch.float32, None),
                                      ("fast_f32_pin", "fast", torch.float32, 0.6),
                                      ("fast_bf16", "fast", torch.bfloat16, None),
                                      ("fast_bf16_pin", "fast", torch.bfloat16, 0.6)):
            table = x.to(dtype)
            bf = dtype == torch.bfloat16
            design = spmm.spmv_design(plan, dtype)
            want = DESIGNS_LARGE[tag][bf]
            check(design == want, f"{tag} {name}: design {design}, expected {want}")
            out = spmm.spmv(plan, table, mode, ts)
            torch.cuda.synchronize()
            check(out.shape == (v + 1, v) and out.dtype == dtype, f"{tag} {name}: shape/dtype")
            check(bool(torch.isfinite(out.float()).all()), f"{tag} {name}: non-finite output")
            check(torch.equal(out, spmm.spmv(plan, table, mode, ts)),
                  f"{tag} {name}: two launches differ")
            tiles_out = spmm.spmv(rows_plan, table, mode, ts)
            unequal_lane = int((out[lane] != tiles_out[lane]).sum().item())
            err_rows = (out.float() - tiles_out.float()).abs().max().item()
            del tiles_out
            plain = spmm.spmv_plain(plan, table, mode, ts)
            diff = (out.float() - plain.float()).abs()
            err_plain = diff.max().item()
            if bf:
                within_plain = bool((diff <= bf16_ulp(torch.maximum(
                    out.float().abs(), plain.float().abs()))).all())
            del plain, diff
            oracle = spmm.spmm_oracle(g, HostRows(table, ts), rows=orows)
            got = out[torch.as_tensor(orows, device=dev)].double().cpu().numpy()
            err_oracle = float(np.abs(got - oracle).max())
            if bf:
                o = torch.from_numpy(oracle)
                within_oracle = bool(((torch.from_numpy(got) - o).abs() <= bf16_ulp(o)).all())
                bound = "1 bf16 ulp relative"
            else:
                within_plain, within_oracle = err_plain <= TOL_F32, err_oracle <= TOL_F32
                bound = f"{TOL_F32:g} absolute"
            ms = cuda_ms(lambda: spmm.spmv(plan, table, mode, ts))
            rows_ms = cuda_ms(lambda: spmm.spmv(rows_plan, table, mode, ts))
            plain_ms = cuda_ms(lambda: spmm.spmv_plain(plan, table, mode, ts), warmup=1, runs=3)
            lib_ms = None
            if ts is None:
                csr = stream_csr(plan, plan.wts).to(dtype)
                lib_ms = library_ms(lambda: torch.sparse.mm(csr, table))
                del csr
            bound_ms, bound_by = bounds.bound(*bounds.spmv_work(
                plan.n_items, 1, v, v, table.element_size(), mode, pin=ts is not None,
                multiply=mode == "kahan"))
            r = dict(case=f"{tag}_{name}", graph=tag, kernel=mode, design=design,
                     items=plan.n_items, width=v, dtype=str(dtype).split(".")[-1],
                     pin=ts is not None, max_abs_err_plain=err_plain,
                     max_abs_err_oracle=err_oracle, oracle_rows=int(len(orows)), bound=bound,
                     max_abs_diff_row_tiles=err_rows, unequal_lane_rows=unequal_lane,
                     ms=ms, row_tiles_ms=rows_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
            results.append(r)
            say(f"{tag} {name} ({design}): err vs plain {err_plain:.3e}, vs float64 oracle "
                f"{err_oracle:.3e} ({len(orows)} rows), bound {bound}; vs row tiles "
                f"{err_rows:.3e}, {unequal_lane} unequal on rows of <= {spmm.SELL_HUB} items; "
                f"kernel {ms:.3f} ms, row tiles {rows_ms:.3f} ms, plain {plain_ms:.3f} ms"
                + ("" if lib_ms is None else f", torch.sparse.mm {lib_ms:.3f} ms")
                + f"; bound {bound_ms:.3f} ms ({bound_by})")
            check(within_plain, f"{tag} {name}: kernel vs plain version outside {bound}")
            check(within_oracle, f"{tag} {name}: kernel vs float64 oracle outside {bound}")
            check(unequal_lane == 0, f"{tag} {name}: {unequal_lane} elements of rows of <= "
                  f"{spmm.SELL_HUB} items differ from the row tiles")
            del out, table
        del x, plan, rows_plan
        torch.cuda.empty_cache()
    report["kernel_cases_large"] = results
    return results


def tree_level_tables(tree, x):
    """The tables each level of ``tree`` reads in the first column block of
    a product over ``x`` (level 0 read in place from the wider iterate),
    row-major."""
    from graphtpu_torch.kernels import spmm

    tables = [x[:, :COL_BLOCK]]
    for k in range(len(tree.levels) - 1):
        tables.append(spmm.gather_rows_sum(tree.levels[k], tree.weights[k], tables[-1]))
    return tables


def phase_tree_kernel(dev, report):
    """B3 on every level of the blog-shaped and R-MAT trees in both designs
    where the column panel takes the level (the panel and the row tiles held
    bit-equal to each other and to the plain version), and the whole blog
    tree product against the float64 oracle."""
    from graphtpu_torch import build_graph
    from graphtpu_torch.bench import bounds
    from graphtpu_torch.kernels import spmm

    g = blog_shaped_graph()
    tree = spmm.build_reduction_tree(g, device=dev)
    edges = blog_shaped_edges()
    weights = (np.random.default_rng(0).random(len(edges)) + 0.1).astype(np.float32)
    gw = build_graph(edges, weights=weights, n_nodes=BLOG_NODES)
    wtree = spmm.build_reduction_tree(gw, weighted=True, device=dev)
    rg = rmat14_graph()
    rtree = spmm.build_reduction_tree(rg, device=dev)
    for tag, t in (("blog", tree), ("blog weighted", wtree), ("rmat", rtree)):
        say(f"{tag} tree: W={t.width}, real rows per level {list(t.real_rows)}, padded "
            f"{[int(l.shape[0]) for l in t.levels]}; compact plans "
            f"{['-' if l is None else f'N={l.n_table}' for l in t.layouts]}, "
            f"built in {t.layout_host_ms:.1f} ms (host)")
    check(tree.layout(0) is not None and all(l is None for l in tree.layouts[1:]),
          "blog tree: the panel should take level 0 only")
    check(all(l is None for l in rtree.layouts), "rmat tree: no level fits the panel")
    check(wtree.layout(0) is None, "weighted blog tree: level 0 (a weight per slot) keeps the row tiles")
    x_np = np.random.default_rng(1).random((BLOG_NODES, BLOG_NODES), dtype=np.float32)
    x = torch.from_numpy(x_np).to(dev)
    xb = x.bfloat16()
    xr = torch.rand((RMAT14_NODES, RMAT14_NODES), generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    tables = tree_level_tables(tree, x)
    rtables = tree_level_tables(rtree, xr)

    def level(t, k, table):
        rows = t.real_rows[k]
        n = t.n_nodes if k == 0 else t.real_rows[k - 1]
        return t.levels[k], t.weights[k], t.layout(k), table, rows, n

    cases = [(f"level{k}" + ("_strided" if k == 0 else ""), *level(tree, k, tables[k]))
             for k in range(len(tree.levels))]
    cases += [
        ("level0_tail_strided", *level(tree, 0, x[:, 2 * COL_BLOCK:])),
        ("level0_C10313", *level(tree, 0, x[:, :C_RAGGED].contiguous())),
        ("level0_bf16_strided", *level(tree, 0, xb[:, :COL_BLOCK])),
        ("level0_weighted_strided", *level(wtree, 0, x[:, :COL_BLOCK])),
    ]
    cases += [(f"rmat_level{k}", *level(rtree, k, rtables[k])) for k in range(len(rtree.levels))]
    results = []
    slab0 = {}  # blog level 0's slab-major output, the table level 1 reads in tree_spmm
    for name, sl, w, lay, table, real, n in cases:
        c = table.shape[1]
        # each design of this level as tree_spmm launches it: row tiles;
        # where the level has a plan, the panel, which stores slab-major for
        # the next level; for blog level 1, the row tiles reading level 0's
        # slabs
        runs = {"rows": lambda: spmm.gather_rows_sum(sl, w, table)}
        if lay is not None:
            runs["panel"] = lambda: spmm._gather_cuda(sl, w, table, None, lay)
        if name == "level1" and "level0_strided" in slab0:
            t0 = slab0["level0_strided"]
            runs["rows_slabs_in"] = lambda: spmm._gather_cuda(sl, w, t0, None, None, c=c,
                                                              table_slabs=True)
        plain = spmm.gather_rows_sum_plain(sl, w, table)
        outs = {d: f() for d, f in runs.items()}
        torch.cuda.synchronize()
        if "panel" in outs:  # slab-major back to rows
            if name == "level0_strided":
                slab0[name] = outs["panel"]
            outs["panel"] = outs["panel"].permute(1, 0, 2).reshape(sl.shape[0], -1)[:, :c]
        unequal = {}
        for d, out in outs.items():
            check(out.shape == (sl.shape[0], c) and out.dtype == torch.float32,
                  f"B3 {name} {d}: shape/dtype {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), f"B3 {name} {d}: non-finite output")
            unequal[d] = int((out != plain).sum().item())
        err = max((o - plain).abs().max().item() for o in outs.values())
        times = {d: cuda_ms(f) for d, f in runs.items()}
        # the design tree_spmm runs this level with
        used = next(d for d in ("panel", "rows_slabs_in", "rows") if d in runs)
        plain_ms = cuda_ms(lambda: spmm.gather_rows_sum_plain(sl, w, table), warmup=1, runs=5)
        lib_ms = None
        if name in ("level0_strided", "rmat_level0"):
            # one PyTorch call of the same level: a bag of W weighted rows per
            # output row, over a contiguous copy of the level's table
            tc = table.contiguous()
            m, wd = sl.shape
            idx, offs = sl.reshape(-1).long(), torch.arange(0, m * wd, wd, device=dev)
            pw = w.reshape(-1)
            lib_ms = library_ms(lambda: torch.nn.functional.embedding_bag(
                idx, tc, offs, mode="sum", per_sample_weights=pw))
            del tc, idx, offs
        bound_ms, bound_by = bounds.bound(*bounds.gather_work(
            real, sl.shape[1], c, n, table.element_size()))
        r = dict(case=name, rows=int(sl.shape[0]), real_rows=int(real), table_rows=int(n),
                 width=int(c), ld=int(table.stride(0)), dtype=str(table.dtype).split(".")[-1],
                 design=used, max_abs_err_plain=err, unequal=unequal[used],
                 unequal_by_design=unequal, ms=times[used], ms_by_design=times,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        results.append(r)
        say(f"B3 {name}: [{r['rows']} x {c}] over {n} rows, ld {r['ld']} {r['dtype']}: "
            f"unequal elements vs plain {unequal}; "
            + ", ".join(f"{d} {t:.3f} ms" for d, t in times.items())
            + f" (tree_spmm runs {used}), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by})" + ("" if lib_ms is None else f", embedding_bag {lib_ms:.3f} ms"))
        check(err <= TOL_B3, f"B3 {name}: kernel vs plain version {err} > {TOL_B3}")
        for d, u in unequal.items():
            check(u == 0, f"B3 {name} {d}: {u} elements differ from the plain version")
        del outs, plain
    del slab0
    del tables, rtables, xr
    # sampled rows plus the hub, an isolated pad row and row 0
    special = [int(np.argmax(g.host[3])), BLOG_NODES - 1, 0]
    rows = np.unique(np.concatenate(
        [np.random.default_rng(2).choice(BLOG_NODES, ORACLE_ROWS), special]))
    prod = spmm.tree_spmm(tree, x, COL_BLOCK)
    got = prod[torch.as_tensor(rows, device=dev)].cpu().numpy()
    err = float(np.abs(got - spmm.spmm_oracle(g, x_np, rows=rows)).max())
    # level 0 runs the panel into a slab-major intermediate; the row tiles
    # alone must give the same bits, over f32 and bf16 iterates
    rows_tree = dataclasses.replace(tree, layouts=())
    times = {}
    for tag, xx in (("f32", x), ("bf16", xb)):
        check(torch.equal(prod if tag == "f32" else spmm.tree_spmm(tree, xx, COL_BLOCK),
                          spmm.tree_spmm(rows_tree, xx, COL_BLOCK)),
              f"tree_spmm over {tag}: the panel and the row tiles differ")
        times[tag] = (cuda_ms(lambda: spmm.tree_spmm(tree, xx, COL_BLOCK), warmup=1, runs=5),
                      cuda_ms(lambda: spmm.tree_spmm(rows_tree, xx, COL_BLOCK), warmup=1, runs=5))
    ms = times["f32"][0]
    say(f"tree_spmm at V = C = {BLOG_NODES}: vs float64 oracle {err:.3e} over {len(rows)} "
        f"rows (bound {TOL_F32:g}); ms per product with the panel / row tiles only (the "
        f"same bits): " + ", ".join(f"{t} {a:.3f} / {b:.3f}" for t, (a, b) in times.items()))
    check(err <= TOL_F32, f"tree_spmm vs float64 oracle {err} > {TOL_F32}")
    report["tree_kernel_cases"] = results
    report["tree_level0"] = dict(real_rows=int(tree.real_rows[0]), width=int(tree.width),
                                 table_rows=int(g.n_nodes), c=COL_BLOCK)
    report["tree_product"] = dict(max_abs_err_oracle=err, oracle_rows=int(len(rows)), ms=ms,
                                  ms_by_dtype={t: dict(panel=a, rows=b)
                                               for t, (a, b) in times.items()})
    del x, xb, prod
    torch.cuda.empty_cache()
    return results


def check_sim_file(sim_path, dense_top, tol, tag):
    """A top-20 ``.sim.txt`` against the dense engine's top-20 scores
    ``dense_top`` [V, 20]: every row there, finite, within ``tol`` (plus the
    file's printed rounding).  Returns (the file's rows, max |err|)."""
    from graphtpu_torch.io.simfile import read_sim_file

    n_nodes = len(dense_top)
    sims = read_sim_file(sim_path)
    check(sorted(sims) == list(range(n_nodes)), f"{tag}: rows in file")
    scores = np.array([[s for _, s in sims[r]] for r in range(n_nodes)])
    check(scores.shape == (n_nodes, 20) and np.isfinite(scores).all(),
          f"{tag}: file scores shape {scores.shape}")
    file_err = float(np.abs(scores - dense_top).max())
    check(file_err <= tol + 5e-7, f"{tag}: file top-20 scores vs dense {file_err}")
    return sims, file_err


@contextlib.contextmanager
def forced_row_tiles():
    """``exact_simrank_spmm`` builds its streams without a layout or plan
    inside the block, so B1/B2 run them as row tiles."""
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.simrank import exact

    build = exact.build_spmv_stream
    exact.build_spmv_stream = lambda *a, **kw: spmm.row_tiles(build(*a, **kw))
    try:
        yield
    finally:
        exact.build_spmv_stream = build


def run_main_path(dev, path, n_nodes, modes, report, tag, want_design,
                  row_tiles_check=False):
    """CLI runs over one edge file, whose stream must get B1/B2's
    ``want_design``; returns each kernel's launches.  With
    ``row_tiles_check`` each mode's in-process call is held within
    TOL_DESIGNS of the same call on forced row tiles."""
    from graphtpu_torch import read_edgelist_graph
    from graphtpu_torch.cli import main as cli_main
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.io.simfile import read_topk_ids
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

    g = read_edgelist_graph(path, n_nodes=n_nodes)
    cfg = SimRankConfig(iterations=3)
    dense = exact_simrank(g, cfg, device=dev)
    dense_top = topk_rows(dense, 20)[0].cpu().numpy()
    launches = {"kahan": 0, "fast": 0}
    ids = {}
    top = {}
    out_rows = []
    for mode in modes:
        kernel = "kahan" if mode == "kahan" else "fast"
        out = os.path.join(os.path.dirname(path), f"{tag}_{mode}.txt")
        argv = ["simrank", "--input", path, "--output", out, "--engine", "spmm",
                "--mode", mode, "--iterations", "3", "--topk", "20",
                "--n-nodes", str(n_nodes)]
        for k in spmm.SPMV_LAUNCHES:
            spmm.SPMV_LAUNCHES[k] = 0
        t0 = time.perf_counter()
        check(cli_main(argv) == 0, f"{tag} {mode}: CLI exit code")
        cli_s = time.perf_counter() - t0
        rise = dict(spmm.SPMV_LAUNCHES)
        for k in launches:
            launches[k] += rise[k]
        want = {k: (2 * cfg.iterations if k == kernel else 0) for k in rise}
        check(rise == want, f"{tag} {mode}: launches {rise}, expected {want}")

        tol = TOL_SIM_BF16 if mode == "fast16" else TOL_SIM_F32
        sims, file_err = check_sim_file(out + ".sim.txt", dense_top, tol, f"{tag} {mode}")
        ids[mode] = read_topk_ids(out)
        top[mode] = np.array([sims[r][0][1] for r in range(n_nodes)])

        stages = {}
        dtype = torch.bfloat16 if mode == "fast16" else torch.float32
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = exact_simrank_spmm(g, cfg, spmv_mode=kernel, dtype=dtype,
                                 device=dev, stage_times=stages)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        err = (sim.float() - dense).abs().max().item()
        design = spmm.spmv_design(spmm.build_spmv_stream(g, device=dev), dtype)
        check(design == want_design, f"{tag} {mode}: design {design}, expected {want_design}")
        per_iter = {k: stages[k] / cfg.iterations
                    for k in ("product1", "transpose", "product2")}
        row = dict(graph=tag, mode=mode, V=n_nodes, slots=g.n_edges,
                   max_degree=g.max_degree, launches=rise, max_abs_err_dense=err,
                   bound=tol, file_topk_err=file_err, cli_wall_s=cli_s,
                   spmm_call_wall_s=call_s, stage_ms_per_iter=per_iter,
                   layout_host_ms=stages["layout_host"], peak_gb=peak_gb, design=design)
        if row_tiles_check:
            rows_stages = {}
            with forced_row_tiles():
                rows_sim = exact_simrank_spmm(g, cfg, spmv_mode=kernel, dtype=dtype,
                                              device=dev, stage_times=rows_stages)
            err_rows = (sim.float() - rows_sim.float()).abs().max().item()
            del rows_sim
            row.update(max_abs_err_row_tiles=err_rows, row_tiles_bound=TOL_DESIGNS,
                       row_tiles_stage_ms_per_iter={
                           k: rows_stages[k] / cfg.iterations
                           for k in ("product1", "transpose", "product2")})
            say(f"{tag} {mode}: S on {design} vs forced row tiles max err {err_rows:.3e} "
                f"(bound {TOL_DESIGNS:g}); row tiles per iteration "
                + ", ".join(f"{k} {v:.3f} ms"
                            for k, v in row["row_tiles_stage_ms_per_iter"].items()))
            check(err_rows <= TOL_DESIGNS,
                  f"{tag} {mode}: S vs forced row tiles {err_rows} > {TOL_DESIGNS}")
        del sim
        out_rows.append(row)
        say(f"{tag} {mode} ({design}): launches {rise}; S vs dense fp32 max err {err:.3e} "
            f"(bound {tol:g}); file top-20 vs dense {file_err:.3e}; per iteration "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in per_iter.items())
            + f" (CUDA events); layout {stages['layout_host']:.1f} ms (host); "
            f"CLI {cli_s:.2f} s, spmm call {call_s:.3f} s (host clock); "
            f"peak {peak_gb:.3f} GB above the {base / 1e9:.3f} GB held")
        check(err <= tol, f"{tag} {mode}: S vs dense {err} > {tol}")
    if "fast16" in ids and "kahan" in ids:
        # rows whose kahan top score is 0 (isolated nodes) are left out
        agree = np.mean([len(set(ids["fast16"][r]) & set(ids["kahan"][r])) / 20
                         for r in range(n_nodes) if top["kahan"][r] > 0])
        report.setdefault("fast16_top20_agreement", {})[tag] = float(agree)
        say(f"{tag}: fast16 top-20 agreement with kahan {agree:.4f} (reported, not gated)")
    report.setdefault("main_path", []).extend(out_rows)
    del dense
    torch.cuda.empty_cache()
    return launches


def run_arxiv_path(dev, path, report):
    """The main path on the arxiv-shaped edge file (V = 38,912, the L2
    column tiles): ``simrank --engine spmm`` for modes kahan and fast in
    process, launch counts and the file read back; then, per mode,
    ``exact_simrank_spmm`` on the stream's design and on forced row tiles
    (``spmm.row_tiles``), within TOL_F32_DIST of each other, the file's
    top-20 scores those of the first; per-iteration stage times, the plan's
    host ms and peak memory.  Returns each kernel's launches."""
    from graphtpu_torch import read_edgelist_graph
    from graphtpu_torch.cli import main as cli_main
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank import exact

    v = ARXIV_NODES
    g = read_edgelist_graph(path, n_nodes=v)
    cfg = SimRankConfig(iterations=ITERATIONS)
    launches = {"kahan": 0, "fast": 0}
    for mode in ("kahan", "fast"):
        out = os.path.join(os.path.dirname(path), f"arxiv_{mode}.txt")
        for k in spmm.SPMV_LAUNCHES:
            spmm.SPMV_LAUNCHES[k] = 0
        t0 = time.perf_counter()
        check(cli_main(["simrank", "--input", path, "--output", out, "--engine", "spmm",
                        "--mode", mode, "--iterations", str(ITERATIONS), "--topk", "20",
                        "--n-nodes", str(v)]) == 0, f"arxiv {mode}: CLI exit code")
        cli_s = time.perf_counter() - t0
        rise = dict(spmm.SPMV_LAUNCHES)
        want = {k: (2 * cfg.iterations if k == mode else 0) for k in rise}
        check(rise == want, f"arxiv {mode}: launches {rise}, expected {want}")
        for k in launches:
            launches[k] += rise[k]
        row = dict(graph="arxiv", mode=mode, V=v, slots=g.n_edges, max_degree=g.max_degree,
                   launches=rise, cli_wall_s=cli_s)
        sims = {}
        for design in ("stream", "row tiles"):
            stages = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with forced_row_tiles() if design == "row tiles" else contextlib.nullcontext():
                t0 = time.perf_counter()
                sims[design] = exact.exact_simrank_spmm(g, cfg, spmv_mode=mode, device=dev,
                                                        stage_times=stages)
                torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            per_iter = {k: stages[k] / cfg.iterations
                        for k in ("product1", "transpose", "product2")}
            row[design] = dict(spmm_call_wall_s=call_s, stage_ms_per_iter=per_iter,
                               layout_host_ms=stages["layout_host"], peak_gb=peak_gb)
            say(f"arxiv {mode} ({design}): per iteration "
                + ", ".join(f"{k} {t:.3f} ms" for k, t in per_iter.items())
                + f" (CUDA events); plan {stages['layout_host']:.1f} ms (host); call "
                f"{call_s:.3f} s (host clock); peak {peak_gb:.3f} GB above the "
                f"{base / 1e9:.3f} GB held")
        s = sims["stream"]
        check(s.shape == (v, v) and bool(torch.isfinite(s).all()), f"arxiv {mode}: scores")
        err = (s - sims["row tiles"]).abs().max().item()
        del sims
        top = topk_rows(s, 20)[0].cpu().numpy()
        del s
        torch.cuda.empty_cache()
        _, file_err = check_sim_file(out + ".sim.txt", top, TOL_DESIGNS, f"arxiv {mode}")
        row.update(max_abs_err_row_tiles=err, bound=TOL_DESIGNS, file_topk_err=file_err)
        report.setdefault("main_path", []).append(row)
        say(f"arxiv {mode}: launches {rise}; S vs forced row tiles max err {err:.3e} (bound "
            f"{TOL_DESIGNS:g}); file top-20 vs the call {file_err:.3e}; CLI {cli_s:.2f} s")
        check(err <= TOL_DESIGNS, f"arxiv {mode}: S vs forced row tiles {err} > {TOL_DESIGNS}")
    return launches


def run_tree_path(dev, g, tag, dtypes, report):
    """``exact_simrank_spmm(impl="tree")`` on ``g``; returns B3's launches."""
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

    cfg = SimRankConfig(iterations=ITERATIONS)
    v = g.n_nodes
    dense = exact_simrank(g, cfg, device=dev)
    levels = len(spmm.build_reduction_tree(g).levels)
    want = cfg.iterations * 2 * -(-v // COL_BLOCK) * levels
    total = 0
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        tol = TOL_SIM_BF16 if dtype == torch.bfloat16 else TOL_SIM_F32
        stages = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        spmm.GATHER_LAUNCHES["gather_rows_sum"] = 0
        t0 = time.perf_counter()
        sim = exact_simrank_spmm(g, cfg, dtype=dtype, impl="tree", device=dev,
                                 col_block=COL_BLOCK, stage_times=stages)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = spmm.GATHER_LAUNCHES["gather_rows_sum"]
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        total += launches
        check(sim.shape == (v, v) and sim.dtype == dtype, f"{tag} tree {name}: shape/dtype")
        check(bool(torch.isfinite(sim.float()).all()), f"{tag} tree {name}: non-finite scores")
        err = (sim.float() - dense).abs().max().item()
        del sim
        per_iter = {k: stages[k] / cfg.iterations
                    for k in ("product1", "transpose", "product2")}
        report.setdefault("tree_path", []).append(dict(
            graph=tag, dtype=name, V=v, slots=g.n_edges, levels=levels,
            launches=launches, expected_launches=want, max_abs_err_dense=err,
            bound=tol, call_wall_s=call_s, stage_ms_per_iter=per_iter,
            layout_host_ms=stages["layout_host"], peak_gb=peak_gb))
        say(f"{tag} tree {name}: {levels} levels, B3 launches {launches} (expected "
            f"{want}); S vs dense fp32 max err {err:.3e} (bound {tol:g}); per iteration "
            + ", ".join(f"{k} {t:.3f} ms" for k, t in per_iter.items())
            + f" (CUDA events; product2 includes scale, pin and cast); compact plans "
            f"{stages['layout_host']:.1f} ms (host); call {call_s:.3f} s "
            f"(host clock); peak {peak_gb:.3f} GB above the {base / 1e9:.3f} GB held")
        check(launches == want, f"{tag} tree {name}: {launches} B3 launches, expected {want}")
        check(err <= tol, f"{tag} tree {name}: S vs dense {err} > {tol}")
    del dense
    torch.cuda.empty_cache()
    return total


def rate_library(key, stream, arg):
    """One PyTorch call of rate kernel ``key``'s function over ``stream``,
    or None: X1 a max bag, X2 a weighted sum bag over t mod 16, X3 a
    ones-CSR times the table."""
    from graphtpu_torch.bench import spmv_rate

    f = torch.nn.functional
    offs = stream.row_items[:-1]  # bags of rows 0..V, the last to the end
    if key == "gather_only":
        idx = stream.slots.long()
        return lambda: f.embedding_bag(idx, arg, offs, mode="max")
    if key == "accumulate_only":
        idx = torch.arange(stream.slots.numel(), device=arg.device) % spmv_rate.N_BUF
        return lambda: f.embedding_bag(idx, arg, offs, mode="sum",
                                       per_sample_weights=stream.wts)
    ones = stream_csr(stream, torch.ones_like(stream.wts))
    return lambda: torch.sparse.mm(ones, arg)


def phase_rate_probe(dev, report):
    """The probe's entry point on both graphs, then X1-X3 against their
    plain versions (and, at blog, each beside one PyTorch library call of
    its function, checked once against the plain version); returns the X
    kernels' launches and their cases."""
    from graphtpu_torch.bench import spmv_rate
    from graphtpu_torch.kernels import spmm

    for k in spmv_rate.RATE_LAUNCHES:
        spmv_rate.RATE_LAUNCHES[k] = 0
    report["rate_probe"] = spmv_rate.main([])
    launches = dict(spmv_rate.RATE_LAUNCHES)
    say(f"rate probe launches {launches}")
    for tag, res in report["rate_probe"]["graphs"].items():
        by = {r["kernel"]: r for r in res["rows"]}
        b2 = by["B2 fast f32"]
        for name, what in (("X1 gather only", "B2's reads, a max for the add"),
                           ("X2 accumulate only", "B2's per-item work, no reads"),
                           ("X3 unroll", "twice B2's items in flight")):
            x = by[name]
            say(f"{tag}: {name.split()[0]} ({x['design']}, {what}) {x['ms']:.3f} ms beside B2 "
                f"fast f32 ({b2['design']}) {b2['ms']:.3f} ms: "
                f"{name.split()[0]}/B2 {x['ms'] / b2['ms']:.3f}")
        if b2["design"] == "panel":
            share = b2["ms"] - by["X2 accumulate only"]["ms"]
            say(f"{tag}: B2 - X2 = {share:.3f} ms, the panel's copy-in and reads "
                f"({share / b2['ms']:.3f} of B2)")
    # X2 over R-MAT's sliced layout (the table past the panel; X2 reads none):
    # that layout's walk, flushes and hub join, beside blog's X2 a chunk and slab
    blog_x2 = next(r for r in report["rate_probe"]["graphs"]["blog"]["rows"]
                   if r["kernel"] == "X2 accumulate only")
    for r in report["rate_probe"]["graphs"]["rmat"]["rows"]:
        if "ns_per_chunk_slab" in r:
            say(f"rmat: {r['kernel']} ({r['design']}) {r['ms']:.3f} ms, "
                f"{r['ns_per_chunk_slab']:.3f} ns per chunk and slab ({r['chunks']} chunks); "
                f"blog's X2 {blog_x2.get('ns_per_chunk_slab', float('nan')):.3f} "
                f"({blog_x2.get('chunks')} chunks)")

    cases = []
    for tag in ("blog", "rmat"):
        g = spmv_rate.GRAPHS[tag]()
        stream = spmm.build_spmv_stream(g, device=dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        table = torch.rand((g.n_nodes, g.n_nodes), generator=gen, device=dev)
        buf = torch.rand((spmv_rate.N_BUF, g.n_nodes), generator=gen, device=dev)
        rows_st = spmm.row_tiles(stream)
        lane = np.arange(g.n_nodes + 1)
        if stream.sell is not None:
            lane = np.setdiff1d(lane, stream.sell.hub_rows.cpu().numpy())
        lane = torch.as_tensor(lane, device=dev)
        for key, label, _ in RATE_KERNELS:
            fn = getattr(spmv_rate, key)
            plain_fn = getattr(spmv_rate, key + "_plain")
            arg = buf if key == "accumulate_only" else table
            used = spmv_rate.design(key, stream)
            out = fn(stream, arg)
            torch.cuda.synchronize()
            plain = plain_fn(stream, arg)
            check(out.shape == (g.n_nodes + 1, g.n_nodes) and bool(torch.isfinite(out).all()),
                  f"{tag} {label}: shape or non-finite output")
            check(torch.equal(out, fn(stream, arg)), f"{tag} {label}: two launches differ")
            unequal_rows = None
            if used == "panel":
                # the row tiles on the same stream: a max is exact, and the
                # panel sums a lane row's items in the row tiles' order
                on = slice(None) if key == "gather_only" else lane
                unequal_rows = int((out[on] != fn(rows_st, arg)[on]).sum().item())

            def within(got):
                """(ok, max |got - plain|, bound) of an output against the plain
                one's first rows (the ones-CSR product has no dummy row V)."""
                ref = plain[: got.shape[0]]
                diff = (got - ref).abs()
                if key == "gather_only":
                    return torch.equal(got, ref), diff.max().item(), "exact"
                # every term is >= 0, so the plain sum is the row's sum of |terms|
                return (bool((diff <= TOL_RATE * ref).all()), diff.max().item(),
                        f"{TOL_RATE:g} of sum|terms|")

            ok, err, bound = within(out)
            ms = cuda_ms(lambda: fn(stream, arg))
            ms_by_design = {used: ms}
            if used == "panel":
                ms_by_design["rows"] = cuda_ms(lambda: fn(rows_st, arg))
            plain_ms = cuda_ms(lambda: plain_fn(stream, arg), warmup=1, runs=3)
            lib_ms = lib_err = None
            if tag == "blog":
                lib = rate_library(key, stream, arg)
                lib_ms = library_ms(lib)
                if lib_ms is not None:
                    lib_ok, lib_err, _ = within(lib())
                    check(lib_ok, f"{tag} {label}: the library call is not the same function "
                                  f"(max |lib - plain| {lib_err:.3e}, bound {bound})")
                del lib
            cases.append(dict(graph=tag, kernel=key, design=used, max_abs_err_plain=err,
                              bound=bound, ms=ms, ms_by_design=ms_by_design, plain_ms=plain_ms,
                              library_ms=lib_ms, library_max_abs_err_plain=lib_err,
                              unequal_vs_row_tiles=unequal_rows, items=stream.n_items,
                              v=g.n_nodes))
            say(f"{tag} {label} ({used}): err vs plain {err:.3e} (bound {bound}); kernel "
                + ", ".join(f"{d} {t:.3f} ms" for d, t in ms_by_design.items())
                + f", plain {plain_ms:.3f} ms"
                + ("" if lib_ms is None else
                   f", library call {lib_ms:.3f} ms (err vs plain {lib_err:.3e})")
                + ("" if unequal_rows is None else
                   f"; {unequal_rows} elements unequal to the row tiles'"
                   + (" (all rows)" if key == "gather_only" else " (lane rows)")))
            check(ok, f"{tag} {label}: kernel vs plain version outside {bound}")
            check(unequal_rows in (None, 0), f"{tag} {label}: the panel and the row tiles differ")
            del out, plain
        if stream.sell is None:
            # X2 over the sliced layout of a table past the panel, as the
            # probe ran it: the row tiles' bits on lane rows, and every row
            # within two plain f32 sums' error bound of its plain version,
            # 2·(n - 1)·2^-24·sum|terms| for n items (R-MAT's rows of up to
            # 4,086 items, summed in two orders, differ by more than TOL_RATE)
            sliced = dataclasses.replace(rows_st, sell=spmm.build_sell_layout(stream))
            out = spmv_rate.accumulate_only(sliced, buf)
            plain = spmv_rate.accumulate_only_plain(stream, buf)
            lane = torch.as_tensor(np.setdiff1d(np.arange(g.n_nodes + 1),
                                                sliced.sell.hub_rows.cpu().numpy()), device=dev)
            unequal = int((out[lane] != spmv_rate.accumulate_only(rows_st, buf)[lane]).sum())
            n = torch.diff(stream.row_items).clamp(min=2).float()[:, None]
            within = bool(((out - plain).abs() <= 2 * (n - 1) * 2.0**-24 * plain).all())
            err = (out - plain).abs().max().item()
            say(f"{tag} X2 over its sliced layout ({sliced.sell.n_chunks} chunks, no panel): "
                f"err vs plain {err:.3e} (bound 2(n-1)2^-24 sum|terms| a row); {unequal} "
                "elements unequal to the row tiles' (lane rows)")
            check(within and unequal == 0,
                  f"{tag} X2 over the sliced layout: outside the bound or off the row tiles")
            del out, plain, sliced
        del table, buf
        torch.cuda.empty_cache()
    report["rate_cases"] = cases
    return launches, cases


def walks_valid(g, walks, tag):
    """Every transition of ``walks`` an edge (``edge_exists`` on the card),
    -1 from the first dead step on; returns the number of transitions."""
    from graphtpu_torch.kernels.sampling import edge_exists

    a, b = walks[:, :-1], walks[:, 1:]
    live = b >= 0
    check(bool(edge_exists(g, a[live], b[live]).all()), f"{tag}: a transition is not an edge")
    dead = (walks < 0).int().cummax(dim=1).values.bool()
    check(bool((walks[dead] == -1).all()), f"{tag}: a walk goes on after a dead end")
    return int(live.sum().item())


def timed_call(fn, runs=3):
    """(median CUDA-event ms, median host ms) of ``fn()`` after one warm call."""
    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(a.elapsed_time(b))
    return float(np.median(dev)), float(np.median(host))


def hop_rate(name, fn, hops, report):
    """M hops/s of one walk call, and the share of its host time the card
    was busy."""
    ev_ms, host_ms = timed_call(fn)
    busy = busy_ms(fn)
    r = dict(hops=hops, events_ms=ev_ms, host_ms=host_ms,
             mhops_per_s_events=hops / ev_ms / 1e3, mhops_per_s_host=hops / host_ms / 1e3,
             busy_ms=busy, busy_share=None if busy is None else busy / host_ms)
    report[name] = r
    say(f"{name}: {hops:,} hops in {ev_ms:.3f} ms (CUDA events) / {host_ms:.3f} ms (host): "
        f"{r['mhops_per_s_events']:.1f} / {r['mhops_per_s_host']:.1f} M hops/s; card busy "
        + ("not measured (the profiler recorded no device interval)" if busy is None else
           f"{busy:.3f} ms, {r['busy_share']:.3f} of the host time"))
    return r


def phase_walks(dev, report):
    """Walk validity, second-order transition law, hop rates and one hop's
    split; returns the blog p = 1, q = 2 corpus for phase 10."""
    from graphtpu_torch.core.graph import padded_neighbors
    from graphtpu_torch.kernels.edgeset import device_edge_set, edge_set_contains
    from graphtpu_torch.kernels.sampling import row_spans
    from graphtpu_torch.walks import node2vec as n2v
    from graphtpu_torch.walks.walker import simulate_walks, uniform_walks

    out = report.setdefault("walks", {})
    g = blog_shaped_graph(device=dev)
    t0 = time.perf_counter()
    es = device_edge_set(g)
    es_ms = 1e3 * (time.perf_counter() - t0)
    gp = v60000_graph().to(dev)
    t0 = time.perf_counter()
    esp = device_edge_set(gp)
    esp_ms = 1e3 * (time.perf_counter() - t0)
    check(es.mode == "bitmap" and esp.mode == "cuckoo", f"edge sets {es.mode}, {esp.mode}")
    out["edge_sets"] = dict(blog=dict(mode=es.mode, bytes=es.words.numel() * 4, build_ms=es_ms),
                            v60000=dict(mode=esp.mode, slots=esp.table.numel(),
                                        build_ms=esp_ms))
    say(f"edge sets: blog bitmap {es.words.numel() * 4 / 1e6:.1f} MB built in {es_ms:.1f} ms; "
        f"V = {V_PANELS} cuckoo, {esp.table.numel():,} slots, built in {esp_ms:.1f} ms (host, "
        f"then copied)")

    # every transition an edge
    corpus = None
    for tag, gg, (p, q), nw, wl in (("blog p=1 q=1", g, (1.0, 1.0), 2, 80),
                                    ("blog p=1 q=2", g, (1.0, 2.0), 10, 80),
                                    (f"V={V_PANELS} p=1 q=2 (cuckoo)", gp, (1.0, 2.0), 1, 40)):
        walks = simulate_walks(gg, nw, wl, 11, p=p, q=q, device=dev)
        n = walks_valid(gg, walks, tag)
        check(walks.shape == (nw * int((gg.host[3] > 0).sum()), wl), f"{tag}: walk shape")
        out.setdefault("valid", {})[tag] = dict(walks=int(walks.shape[0]), transitions=n)
        say(f"{tag}: {walks.shape[0]:,} walks x {wl} nodes, all {n:,} transitions are edges")
        if tag == "blog p=1 q=2":
            corpus = walks

    # the second-order transition law at one (prev, cur)
    rp, col, _, deg = g.host
    prev = int(np.argmax(deg))
    nb = col[rp[prev]: rp[prev + 1]]
    common = [len(np.intersect1d(col[rp[c]: rp[c + 1]], nb)) for c in nb]
    cur = int(nb[int(np.argmax(common))])
    nbrs, nwts = padded_neighbors(g)
    draws = 200_000
    prev_a = torch.full((draws,), prev, dtype=torch.int32, device=dev)
    cur_a = torch.full((draws,), cur, dtype=torch.int32, device=dev)
    tvs = {}
    for p, q in ((0.25, 0.25), (4.0, 0.5), (1.0, 2.0)):
        want = n2v.node2vec_transition_probs(g, prev, cur, p, q)
        for mode in ("rejection", "exact"):
            if mode == "exact":
                nxt = n2v._second_order_step_exact(g, es, nbrs, nwts, prev_a, cur_a, 21,
                                                   1 / p, 1 / q)
            else:
                nxt = n2v._second_order_step_rejection(g, None, es, prev_a, cur_a, 21, 1 / p,
                                                       1 / q, n2v.default_max_trials(p, q),
                                                       False)
            emp = np.bincount(nxt.cpu().numpy(), minlength=g.n_nodes) / draws
            tvs[f"p={p:g} q={q:g} {mode}"] = tv = 0.5 * float(np.abs(emp - want).sum())
            check(tv < 0.02, f"transition law p={p} q={q} {mode}: TV {tv} >= 0.02")
    out["transition_tv"] = dict(prev=prev, cur=cur, cur_degree=int(deg[cur]),
                                triangles=int(max(common)), draws=draws, tv=tvs)
    say(f"transition law at (prev {prev}, cur {cur} of degree {deg[cur]}, {max(common)} "
        f"triangles), {draws:,} draws: TV " + ", ".join(f"{k} {v:.4f}" for k, v in tvs.items())
        + " (bound 0.02)")

    # hop rates at bench.py's shapes
    nodes = np.flatnonzero(deg > 0).astype(np.int32)
    starts = torch.from_numpy(np.random.default_rng(1).choice(nodes, size=65536)).to(dev)
    starts2 = torch.from_numpy(np.random.default_rng(2).choice(nodes, size=32768)).to(dev)
    hop_rate("uniform walks, B = 65,536 x 40 hops",
             lambda: uniform_walks(g, starts, 40, 0, device=dev), 65536 * 40, out)
    hop_rate("node2vec rejection p=1 q=2, B = 32,768 x 20 hops",
             lambda: n2v.node2vec_walks(g, starts2, 20, 1.0, 2.0, 0, eset=es, device=dev),
             32768 * 20, out)

    # one node2vec hop split: cur's row reads, the proposal panel, the
    # edge-set probes and the panel arithmetic, on a state mid-walk
    w = n2v.node2vec_walks(g, starts2, 10, 1.0, 2.0, 3, eset=es, device=dev)
    prev_s, cur_s = w[:, 9].contiguous(), w[:, 10].contiguous()
    t = n2v.default_max_trials(1.0, 2.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = row_spans(g, cur_s)
    props = n2v.propose(g, None, cur_s, rows, t, gen, False)
    is_tri = edge_set_contains(es, prev_s[:, None], props)
    parts = {
        "row reads": lambda: row_spans(g, cur_s),
        "proposals": lambda: n2v.propose(g, None, cur_s, rows, t, gen, False),
        "edge-set probes": lambda: edge_set_contains(es, prev_s[:, None], props),
        "panel arithmetic": lambda: n2v.accept(props, prev_s, is_tri, 1.0, 0.5, gen),
    }
    parts["whole hop"] = lambda: n2v._second_order_step_rejection(g, None, es, prev_s, cur_s, 7,
                                                                  1.0, 0.5, t, False)
    split = {k: cuda_ms(f) for k, f in parts.items()}
    busy = {k: busy_ms(f) for k, f in parts.items()}
    hop, hop_busy = split.pop("whole hop"), busy.pop("whole hop")
    out["hop_split"] = dict(batch=32768, trials=t, hop_ms=hop, hop_busy_ms=hop_busy,
                            parts_ms=split, parts_busy_ms=busy)
    say(f"one node2vec hop (B = 32,768, a one-shot panel of {t}), each part alone, CUDA-event "
        f"ms / ms the card was busy: whole hop {hop:.4f} / "
        + ("not measured" if hop_busy is None else f"{hop_busy:.4f}") + "; "
        + ", ".join(f"{k} {split[k]:.4f} / " + ("not measured" if busy[k] is None else
                                               f"{busy[k]:.4f}") for k in split))
    del nbrs, prev_a, cur_a
    return g, corpus


def phase_sgns(dev, g, corpus, report):
    """SGNS step time and memory, determinism, resume and quality."""
    import graphtpu_torch.models.checkpoint as ckpt
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.config import SGNSConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.models import sgns
    from graphtpu_torch.walks.walker import simulate_walks

    out = report.setdefault("sgns", {})
    v = g.n_nodes
    cfg = SGNSConfig()
    batch, steps = cfg.batch_size, 50
    counts = sgns.corpus_counts(corpus, v)
    neg_j, neg_q = sgns.build_negative_alias(counts)
    gen = torch.Generator(device=dev).manual_seed(0)
    cwalks, _ = sgns.subsample_and_compact(corpus, counts, cfg.subsample, gen)
    perm = torch.randperm(corpus.numel(), generator=gen, device=dev)
    params = (torch.rand((v, cfg.dim), generator=gen, device=dev) - 0.5) / cfg.dim, \
        torch.zeros((v, cfg.dim), device=dev)

    def step(i, params):
        return sgns.batch_step(params, cwalks, perm[i * batch:(i + 1) * batch], cfg.window,
                               neg_j, neg_q, (batch, cfg.negative), gen, 0.01, v)

    def run(params):
        for i in range(steps):
            params = step(i, params)
        return params

    with full_fp32():
        params = run(params)  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev_ms, host_ms = timed_call(lambda: run(params), runs=3)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        busy = busy_ms(lambda: step(0, params))
        one_host = timed_call(lambda: step(0, params), runs=5)[1]
    r = dict(batch=batch, window=cfg.window, negative=cfg.negative, dim=cfg.dim,
             corpus_walks=int(corpus.shape[0]), ms_per_step_events=ev_ms / steps,
             ms_per_step_host=host_ms / steps, peak_gb=peak_gb, busy_ms_one_step=busy,
             busy_share_one_step=None if busy is None else busy / one_host)
    out["step"] = r
    say(f"SGNS step (B = {batch}, W = {cfg.window}, N = {cfg.negative} shared, D = {cfg.dim}; "
        f"gather, negatives, grads, row sums, update): {r['ms_per_step_events']:.3f} ms "
        f"(CUDA events) / {r['ms_per_step_host']:.3f} ms (host) per step over {steps}; card "
        + ("busy not measured" if busy is None else
           f"busy {busy:.3f} ms of a {one_host:.3f} ms step ({r['busy_share_one_step']:.3f})")
        + f"; peak {peak_gb:.3f} GB above the {base / 1e9:.3f} GB held")
    del params

    # determinism and resume: 2 epochs over 20,480 walks, chunks of 50 steps
    sub = corpus[:20480]
    dcfg = SGNSConfig(epochs=2)
    kw = dict(chunk_steps=50, device=dev)
    t0 = time.perf_counter()
    a0, a1 = sgns.train_sgns(sub, v, dcfg, **kw)
    run_s = time.perf_counter() - t0
    b0, b1 = sgns.train_sgns(sub, v, dcfg, **kw)
    same = bool(np.array_equal(a0, b0) and np.array_equal(a1, b1))
    saved, orig = [], ckpt.save_state

    def capture(path, arrays, step=0, meta=None):
        saved.append(({k: np.array(x) for k, x in arrays.items()}, step, dict(meta or {})))
        orig(path, arrays, step=step, meta=meta)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save_state = capture
        try:
            sgns.train_sgns(sub, v, dcfg, checkpoint_path=os.path.join(tmp, "a.npz"),
                            checkpoint_every=1, **kw)
        finally:
            ckpt.save_state = orig
        mid = saved[len(saved) // 2 + 1]  # inside the second epoch
        orig(os.path.join(tmp, "mid.npz"), mid[0], step=mid[1], meta=mid[2])
        r0, r1 = sgns.train_sgns(sub, v, dcfg, checkpoint_path=os.path.join(tmp, "mid.npz"), **kw)
    resumed = bool(np.array_equal(r0, a0) and np.array_equal(r1, a1))
    steps_run = 2 * (sub.numel() // batch)
    out["determinism"] = dict(walks=int(sub.shape[0]), steps=steps_run, chunks=len(saved),
                              run_s=run_s, two_runs_bit_equal=same,
                              resumed_from=mid[2], resume_bit_equal=resumed,
                              max_abs_diff_resume=float(np.abs(r0 - a0).max()))
    say(f"SGNS determinism: {steps_run} steps in {len(saved)} chunks ({run_s:.2f} s a run): two "
        f"runs bit-equal {same}; resumed from {mid[2]} bit-equal {resumed} "
        f"(max |diff| {out['determinism']['max_abs_diff_resume']:.3e})")
    check(same, "two SGNS runs with one seed differ")
    check(resumed, "a resumed SGNS run differs from the uninterrupted one")

    # quality: two disjoint 8-cliques
    edges = [[b + i, b + j] for b in (0, 8) for i in range(8) for j in range(i + 1, 8)]
    cg = build_graph(np.array(edges), n_nodes=16)
    cw = simulate_walks(cg, 30, 20, 0, device=dev)
    e, _ = sgns.train_sgns(cw, 16, SGNSConfig(dim=16, window=4, epochs=10, batch_size=64,
                                              subsample=0), device=dev)
    e = e / np.linalg.norm(e, axis=1, keepdims=True)
    sims = e @ e.T
    intra = float(((sims[:8, :8].sum() - 8) / 56 + (sims[8:, 8:].sum() - 8) / 56) / 2)
    inter = float(sims[:8, 8:].mean())
    out["two_cliques"] = dict(intra=intra, inter=inter)
    say(f"two cliques: mean cosine intra {intra:.4f}, inter {inter:.4f} (need intra > inter + 0.3)")
    check(intra > inter + 0.3, f"two cliques: intra {intra} not above inter {inter} + 0.3")


def phase_cli(tmp, report):
    """``python -m graphtpu_torch node2vec`` at the reference defaults."""
    from graphtpu_torch.io.embfile import read_emb
    from graphtpu_torch.io.edgelist import write_edgelist

    path = os.path.join(tmp, "blog_n2v.txt")
    write_edgelist(path, blog_shaped_edges())
    emb = os.path.join(tmp, "blog.emb")
    argv = [sys.executable, "-m", "graphtpu_torch", "node2vec", "--input", path, "--output",
            emb, "--p", "1", "--q", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"node2vec CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    stages = {k: float(x.split()[0]) for k, x in
              (part.split(" ", 1) for part in line[line.index("(") + 1:-1].split(", "))}
    with open(emb) as f:
        header = f.readline().split()
    labels, vecs = read_emb(emb)
    n_active = len(np.unique(blog_shaped_edges()))
    check(header == [str(n_active), "128"], f"node2vec CLI: header {header}, want {n_active} 128")
    check(vecs.shape == (n_active, 128) and bool(np.isfinite(vecs).all()),
          f"node2vec CLI: rows {vecs.shape} or non-finite values")
    report["cli"] = dict(argv=argv[2:], wall_s=wall, stages_s=stages, rows=int(vecs.shape[0]),
                         dim=int(vecs.shape[1]))
    say(f"node2vec CLI (p=1, q=2, defaults: 10 walks x 80, dim 128, window 10, 10 epochs): "
        f"{wall:.2f} s wall in a subprocess; " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                          stages.items())
        + f"; file header {' '.join(header)}, all {vecs.size:,} values finite")


def memory_peak_gb(fn):
    """(result, peak GB allocated above what was held before) of ``fn()``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def ranked_close(vals, idx, truth, tol):
    """Top-k (vals, idx) against a dense truth: the values are truth's sorted
    rows within tol, and each id's true score within tol of the score at
    its position (ids may differ only among near-ties).  Returns the
    largest value error."""
    order = np.argsort(-truth, axis=1, kind="stable")[:, : vals.shape[1]]
    want = np.take_along_axis(truth, order, 1)
    err = float(np.abs(vals - want).max())
    ids_ok = np.abs(np.take_along_axis(truth, idx.clip(min=0), 1) - want) <= tol
    return err, bool(err <= tol and (ids_ok | (idx == order)).all())


def reuse_window(g, cfg, sources, key):
    """One flagship tile: SAMPLE/TIMES reuse walks per source, the flat item
    stream, per-source sample counts and the per-source top-k, as
    ``uniwalk_simrank_reuse_topk`` accumulates them."""
    from graphtpu_torch.kernels.topk import pair_topk_by_source
    from graphtpu_torch.simrank.uniwalk import _reuse_stream
    from graphtpu_torch.walks.walker import uniform_walks

    times = cfg.reuse_times
    src = torch.from_numpy(np.asarray(sources, np.int32)).to(g.device)
    starts = torch.repeat_interleave(src, cfg.sample // times)
    walks = uniform_walks(g, starts, 2 * cfg.step + times - 1, key, device=g.device)
    srcs, tgts, vals, counts = _reuse_stream(g, cfg, walks)
    del walks
    v, i = pair_topk_by_source(srcs, tgts, vals, src, cfg.topk, counts=counts)
    return v.cpu().numpy(), i.cpu().numpy()


def phase_mc(dev, report):
    """The Monte-Carlo engines on the card: parity, determinism, quality
    against exact SimRank on R-MAT scale 11, the flagship's window shape
    with a resume, and UniWalk/TopSim tile rates, busy share and memory."""
    from graphtpu_torch.bench.generators import rmat_graph
    from graphtpu_torch import build_graph
    from graphtpu_torch.bench.sweep import gold_standard, sweep_topsim, sweep_uniwalk
    from graphtpu_torch.core.config import TopSimConfig, UniWalkConfig
    from graphtpu_torch.dist.windows import read_sweep_results, windowed_topk_sweep
    from graphtpu_torch.simrank import topsim as ts
    from graphtpu_torch.simrank import uniwalk as uw
    from graphtpu_torch.walks.walker import uniform_walks

    out = report.setdefault("mc", {})
    g = blog_shaped_graph(device=dev)
    v = g.n_nodes

    # parity: the sort-based reuse top-k against the dense scatter oracle,
    # fed the same walks at blog width
    rcfg = UniWalkConfig(sample=400, step=5, reuse_times=4, topk=20)
    starts = torch.repeat_interleave(torch.arange(v, dtype=torch.int32, device=dev), 100)
    walks = uniform_walks(g, starts, 2 * 5 + 3, 21, device=dev)
    rv, ri = uw.uniwalk_simrank_reuse_topk(g, rcfg, walks=walks, device=dev)
    dense = uw.uniwalk_simrank_reuse(g, rcfg, walks=walks, device=dev)
    err, ok = ranked_close(rv, ri, dense, TOL_MC_PARITY)
    n_items = int(walks.shape[0]) * 4 * 5
    del walks, dense
    out["reuse_parity"] = dict(v=v, walks=int(starts.numel()), items=n_items, max_abs_err=err)
    say(f"reuse top-k (sort-based) against the dense scatter at blog ({starts.numel():,} walks, "
        f"{n_items:,} items): max |err| {err:.3e} (bound {TOL_MC_PARITY:g}), ids agree "
        f"{ok}")
    check(ok, f"reuse top-k and the dense oracle differ: {err}")
    torch.cuda.empty_cache()

    # parity: full enumeration has no randomness, card against CPU
    rng = np.random.default_rng(6)
    ring = [[i, (i + 1) % 60] for i in range(60)]
    chords = [[int(a), int(b)] for a, b in rng.integers(0, 60, (40, 2)) if a != b]
    eg = build_graph(np.array(ring + chords), n_nodes=60)
    check(eg.max_degree <= 7, f"enumerate graph max degree {eg.max_degree}")
    ecfg = TopSimConfig(step=3, sample=10.0, topk=10, source_tile=8, enumerate_all=True)
    esrc = np.arange(0, 60, 4, dtype=np.int32)
    e_cpu = ts.topsim_simrank(eg, ecfg, sources=esrc, dense=True, device="cpu")
    e_card = ts.topsim_simrank(eg, ecfg, sources=esrc, dense=True, device=dev)
    err = float(np.abs(e_card - e_cpu).max())
    out["enumerate_parity"] = dict(max_degree=eg.max_degree, slots=ts.frontier_capacity(eg, ecfg),
                                   sources=len(esrc), max_abs_err=err)
    say(f"TopSim enumerate, step 3, max degree {eg.max_degree} "
        f"({ts.frontier_capacity(eg, ecfg):,} slots): card against CPU max |err| {err:.3e} "
        f"(bound {TOL_MC_ENUM:g})")
    check(err <= TOL_MC_ENUM, f"enumerate on the card differs from the CPU: {err}")

    # determinism: two runs with one seed, 256 blog sources
    ucfg = UniWalkConfig()
    src256 = np.arange(256, dtype=np.int32)
    a = uw.uniwalk_simrank(g, ucfg, key=5, sources=src256, device=dev)
    b = uw.uniwalk_simrank(g, ucfg, key=5, sources=src256, device=dev)
    same = bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
    out["determinism"] = dict(sources=256, sample=ucfg.sample, step=ucfg.step, bit_equal=same)
    say(f"UniWalk twice with one seed (256 blog sources, sample {ucfg.sample}, step "
        f"{ucfg.step}): bit-equal {same}")
    check(same, "two UniWalk runs with one seed differ")

    # quality against exact SimRank on R-MAT scale 11
    rg = build_graph(rmat_graph(scale=11, n_edges=41_000, seed=0), n_nodes=2048)
    t0 = time.perf_counter()
    gold = gold_standard(rg, device=dev)
    gold_s = time.perf_counter() - t0
    quality = dict(v=rg.n_nodes, edges=rg.n_edges, gold_s=gold_s)
    for name, run in (("uniwalk", sweep_uniwalk), ("topsim", sweep_topsim)):
        r = run(rg, gold, samples=[10000], step=3, topk=20, device=dev)[0]
        ref = GRAPHTPU_RMAT11[name]
        quality[name] = dict(precision=r.precision, ndcg=r.ndcg, seconds=r.seconds,
                             graphtpu=ref)
        say(f"R-MAT 11, {name} (sample 10,000, step 3, all 2,048 sources, top 20): "
            f"precision {r.precision:.4f} (graphtpu {ref['precision']:.4f}), NDCG "
            f"{r.ndcg:.4f} (graphtpu {ref['ndcg']:.4f}); {r.seconds:.2f} s")
        for m in ("precision", "ndcg"):
            check(getattr(r, m) >= ref[m] - QUALITY_MARGIN,
                  f"{name} {m} {getattr(r, m)} below graphtpu's {ref[m]} - {QUALITY_MARGIN}")
    out["quality_rmat11"] = quality

    # the flagship's shape: two windows of 512 blog sources, stopped after
    # the first and resumed
    fcfg = UniWalkConfig(sample=10_000, step=5, reuse_times=4, topk=20)
    win_s, calls = [], []

    def tile(sources, key):
        if len(calls) == 1 and not resumed:
            raise KeyboardInterrupt  # the job is killed before window 2
        calls.append(int(sources[0]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = reuse_window(g, fcfg, sources, key)
        win_s.append(time.perf_counter() - t)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        resumed = False
        try:
            windowed_topk_sweep(tile, 1024, tmp, window=512, key=3)
            check(False, "the first sweep was not stopped")
        except KeyboardInterrupt:
            pass
        resumed = True
        (_, peak) = memory_peak_gb(lambda: windowed_topk_sweep(tile, 1024, tmp, window=512,
                                                               key=3))
        merged = read_sweep_results(tmp)
    check(calls == [0, 512], f"windows ran {calls}")
    check(sorted(merged) == list(range(1024)), "a source is missing or repeated after resume")
    ok_rows = all(all(0 <= i < v and i != s and 0 < x for i, x in p) for s, p in merged.items())
    check(ok_rows, "a flagship row holds an invalid neighbour or score")
    per = 512 * (fcfg.sample // 4)
    out["flagship_window"] = dict(sources=1024, window=512, walks_per_window=per,
                                  hops_per_window=per * (2 * 5 + 3),
                                  items_per_window=per * 4 * 5, s_per_window=win_s,
                                  peak_gb_second_window=peak)
    say(f"flagship shape (SAMPLE {fcfg.sample:,}, TIMES 4, STEP 5): 1,024 blog sources in "
        f"windows of 512, stopped after the first and resumed: every source once; "
        f"{per:,} walks x {2 * 5 + 3} hops, {per * 20:,} items a window; s per window "
        + ", ".join(f"{s:.3f}" for s in win_s) + f"; peak {peak:.3f} GB (second window)")

    # rates at the CLI defaults: one UniWalk tile (256 x 10,000 walks of 10
    # hops) and its parts; one TopSim tile (32 sources, 20,008 slots)
    key = 11
    src = torch.arange(ucfg.source_tile, dtype=torch.int32, device=dev)
    tile_fn = lambda: uw.uniwalk_tile_topk(g, src, key, ucfg)  # noqa: E731
    (_, uw_peak) = memory_peak_gb(tile_fn)
    ev_ms, host_ms = timed_call(tile_fn)
    busy = busy_ms(tile_fn)
    walkers = ucfg.source_tile * ucfg.sample
    hops, items = walkers * 2 * ucfg.step, walkers * ucfg.step
    walks_t = uw._tile_walks(g, src, key, ucfg.sample, ucfg.step)
    tg_, tv_ = uw._tile_items(g.deg, walks_t, ucfg.step, ucfg.c, ucfg.sample)
    from graphtpu_torch.kernels.topk import segment_topk

    parts = {"walks": cuda_ms(lambda: uw._tile_walks(g, src, key, ucfg.sample, ucfg.step)),
             "items": cuda_ms(lambda: uw._tile_items(g.deg, walks_t, ucfg.step, ucfg.c,
                                                     ucfg.sample)),
             "segment_topk": cuda_ms(lambda: segment_topk(tg_, tv_, ucfg.topk, v))}
    del walks_t, tg_, tv_
    r = dict(tile=ucfg.source_tile, sample=ucfg.sample, step=ucfg.step, hops=hops, items=items,
             events_ms=ev_ms, host_ms=host_ms, mhops_per_s_events=hops / ev_ms / 1e3,
             mhops_per_s_host=hops / host_ms / 1e3, mitems_per_s_events=items / ev_ms / 1e3,
             mitems_per_s_host=items / host_ms / 1e3, busy_ms=busy,
             busy_share=None if busy is None else busy / host_ms, parts_ms=parts,
             peak_gb=uw_peak)
    out["uniwalk_tile"] = r
    say(f"UniWalk tile at the CLI defaults ({ucfg.source_tile} sources x {ucfg.sample:,} walks "
        f"x {2 * ucfg.step} hops): "
        f"{ev_ms:.3f} ms (CUDA events) / {host_ms:.3f} ms (host): "
        f"{r['mhops_per_s_events']:.1f} / {r['mhops_per_s_host']:.1f} M hops/s, "
        f"{r['mitems_per_s_events']:.1f} / {r['mitems_per_s_host']:.1f} M items/s; card busy "
        + ("not measured" if busy is None else f"{busy:.3f} ms ({r['busy_share']:.3f})")
        + "; parts alone (ms): " + ", ".join(f"{k} {x:.3f}" for k, x in parts.items())
        + f"; peak {uw_peak:.3f} GB")

    tcfg = TopSimConfig()
    cap = ts.frontier_capacity(g, tcfg)
    tsrc = torch.arange(tcfg.source_tile, dtype=torch.int32, device=dev)

    def ts_tile():
        targets, vals, lost = ts.topsim_tile_items(g, tsrc, key, tcfg, cap)
        return segment_topk(targets, vals, tcfg.topk, v), lost

    ((_, lost), ts_peak) = memory_peak_gb(ts_tile)
    ev_ms, host_ms = timed_call(ts_tile)
    busy = busy_ms(ts_tile)
    out["topsim_tile"] = dict(tile=tcfg.source_tile, sample=tcfg.sample, step=tcfg.step,
                              slots=cap, events_ms=ev_ms, host_ms=host_ms, busy_ms=busy,
                              busy_share=None if busy is None else busy / host_ms,
                              peak_gb=ts_peak, dropped_mass=float(lost.sum()))
    say(f"TopSim tile at the CLI defaults ({tcfg.source_tile} sources, sample {tcfg.sample:g}, "
        f"step {tcfg.step}, {cap:,} slots): "
        f"{ev_ms:.3f} ms (CUDA events) / {host_ms:.3f} ms (host) per tile; card busy "
        + ("not measured" if busy is None else f"{busy:.3f} ms ({busy / host_ms:.3f})")
        + f"; peak {ts_peak:.3f} GB; dropped mass {float(lost.sum()):g}")
    check(float(lost.sum()) == 0.0, "TopSim dropped mass at its default capacity")


def run_cli(argv, timeout=600):
    """(wall s, stdout) of ``python -m graphtpu_torch <argv>`` in a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{argv[0]} CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    return wall, proc.stdout


def check_topk_files(out, n, k, tag):
    """Both twin files: one row per node, ids valid and not the source,
    scores finite, positive and descending.  Returns the rows' mean length."""
    from graphtpu_torch.io.simfile import read_sim_file, read_topk_ids

    sims, ids = read_sim_file(out + ".sim.txt"), read_topk_ids(out)
    check(sorted(sims) == sorted(ids) == list(range(n)), f"{tag}: rows are not 0..{n - 1}")
    for s, pairs in sims.items():
        sc = [x for _, x in pairs]
        check([i for i, _ in pairs] == ids[s] and len(pairs) <= k, f"{tag}: row {s} twin files")
        check(all(0 <= i < n and i != s for i, _ in pairs), f"{tag}: row {s} ids")
        check(all(np.isfinite(x) and x > 0 for x in sc) and sc == sorted(sc, reverse=True),
              f"{tag}: row {s} scores")
    return float(np.mean([len(p) for p in sims.values()]))


def phase_mc_cli(tmp, report):
    """``python -m graphtpu_torch uniwalk`` and ``topsim`` at the defaults on
    the blog-shaped edge file, then ``sweep`` on R-MAT scale 11."""
    from graphtpu_torch.bench.generators import rmat_graph
    from graphtpu_torch.io.edgelist import write_edgelist

    out = report.setdefault("mc_cli", {})
    path = os.path.join(tmp, "blog_mc.txt")
    edges = blog_shaped_edges()
    write_edgelist(path, edges)
    n = int(edges.max()) + 1
    for cmd in ("uniwalk", "topsim"):
        res = os.path.join(tmp, f"{cmd}.txt")
        wall, stdout = run_cli([cmd, "--input", path, "--output", res])
        line = stdout.strip().splitlines()[-1]
        stages = dict(part.rsplit(" ", 1) for part in
                      line[line.index(") (") + 3:-1].replace(" s", "").split(", "))
        stages = {k: float(x) for k, x in stages.items()}
        width = check_topk_files(res, n, 20, cmd)
        out[cmd] = dict(wall_s=wall, stages_s=stages, rows=n, mean_row_len=width)
        say(f"{cmd} CLI (defaults) on the blog edge file ({n:,} nodes): {wall:.2f} s wall in a "
            f"subprocess; " + ", ".join(f"{k} {x:g}" + ("" if k == "dropped mass" else " s")
                                         for k, x in stages.items())
            + f"; {n:,} rows of {width:.2f} neighbours on average")
        if cmd == "topsim":
            check(stages["dropped mass"] == 0.0, "topsim CLI dropped mass")
    rpath = os.path.join(tmp, "rmat11.txt")
    write_edgelist(rpath, rmat_graph(scale=11, n_edges=41_000, seed=0))
    wall, stdout = run_cli(["sweep", "--input", rpath, "--log", os.path.join(tmp, "sweep.log"),
                            "--algorithm", "uniwalk", "--samples", "1000", "10000"])
    lines = stdout.strip().splitlines()
    check(len(lines) == 2, f"sweep printed {lines}")
    prec = [float(ln.split("precision=")[1].split()[0]) for ln in lines]
    check(prec[1] >= prec[0] - 0.02, f"sweep precision fell from {prec[0]} to {prec[1]}")
    out["sweep"] = dict(wall_s=wall, lines=lines)
    say(f"sweep CLI (R-MAT 11, uniwalk, samples 1,000 and 10,000): {wall:.2f} s wall; "
        + " | ".join(lines))


def simrank_cli_checked(dev, path, out, tag):
    """``simrank --engine spmm --mode kahan`` (kernel B1) on ``path`` in a
    subprocess, as a user runs it, with no ``--n-nodes`` and no
    ``--device``: its launches, counted from 0 in that process and printed
    on its last line, and its top-20 file against the dense float32 engine
    on the same graph.  Returns (wall s, launches, file max |err|)."""
    from graphtpu_torch import read_edgelist_graph
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.kernels.topk import topk_rows
    from graphtpu_torch.simrank.exact import exact_simrank

    wall, stdout = run_cli(["simrank", "--input", path, "--output", out, "--engine", "spmm",
                            "--mode", "kahan", "--iterations", str(ITERATIONS), "--c", "0.6",
                            "--topk", "20"])
    line = stdout.strip().splitlines()[-1]
    launched = {k: int(x) for k, x in re.findall(r"(\w+) (\d+)", line.split("launches:")[1])}
    check(launched == {"kahan": 2 * ITERATIONS, "fast": 0},
          f"simrank CLI ({tag}): kernel launches {launched}")
    g = read_edgelist_graph(path)
    dense = exact_simrank(g, SimRankConfig(iterations=ITERATIONS, c=0.6), device=dev)
    dense_top = topk_rows(dense, 20)[0].cpu().numpy()
    del dense
    torch.cuda.empty_cache()
    _, err = check_sim_file(out + ".sim.txt", dense_top, TOL_SIM_F32, f"simrank CLI ({tag})")
    return wall, launched, err


def stages_of(stdout):
    """{stage: seconds} from a CLI's last line, ``... (a 1.0 s, b 2.0 s)``."""
    line = stdout.strip().splitlines()[-1]
    return {k: float(x) for k, x in re.findall(r"(\w+) ([\d.]+) s\b", line)}


def phase_deepsim(dev, tmp, report):
    """The DeepSim path on the blog edge file: ``simrank`` (kernel B1, its
    file held against the dense engine) and ``deepsim`` in subprocesses,
    ``lookup_sim`` against a dictionary, then in process ``train_deepsim``'s
    wall per step and the loss's descent, ``Trainer.step``'s time, launches,
    busy share and memory, and two seeded runs.  Returns the .sim.txt
    path."""
    from graphtpu_torch.core.config import DeepSimConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.core.graph import read_edgelist_graph
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.io.edgelist import write_edgelist
    from graphtpu_torch.io.embfile import read_emb
    from graphtpu_torch.models import deepsim as ds
    from graphtpu_torch.pipelines_deepsim import read_simrank
    from graphtpu_torch.walks.walker import simulate_walks

    out = report.setdefault("deepsim", {})
    path = os.path.join(tmp, "blog_ds.txt")
    edges = blog_shaped_edges()
    write_edgelist(path, edges)
    n = int(edges.max()) + 1
    sr = os.path.join(tmp, "blog_sr")
    wall, launched, sr_err = simrank_cli_checked(dev, path, sr, "blog, for DeepSim")
    emb = os.path.join(tmp, "blog_ds.emb")
    wall2, stdout2 = run_cli(["deepsim", "--input", path, "--simrank-path", sr + ".sim.txt",
                              "--emb-output", emb, "--steps", str(DEEPSIM_STEPS)])
    stages = stages_of(stdout2)
    with open(emb) as f:
        header = f.readline().split()
    _, vecs = read_emb(emb)
    check(header == [str(n), "128"] and vecs.shape == (n, 128) and bool(np.isfinite(vecs).all()),
          f"deepsim CLI: header {header}, rows {vecs.shape}")
    n_active = len(np.unique(edges))
    out["cli"] = dict(simrank_wall_s=wall, simrank_launches=launched,
                      simrank_file_err_vs_dense=sr_err, wall_s=wall2,
                      steps=DEEPSIM_STEPS, stages_s=stages, rows=int(vecs.shape[0]),
                      active_rows=n_active)
    say(f"simrank CLI (spmm kahan, 3 iterations, C = 0.6, top 20, V = {n:,}) {wall:.2f} s "
        f"wall, kernel launches {launched}, file top-20 vs the dense engine {sr_err:.3e} "
        f"(bound {TOL_SIM_F32:g}); deepsim CLI ({DEEPSIM_STEPS} steps, dim 128, window 10, "
        f"minibatch 128, walks 10 x 80) {wall2:.2f} s wall in a subprocess; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; .emb {' '.join(header)}, all {vecs.size:,} values finite")

    # lookup_sim on the card against a dictionary lookup, exactly
    sims = read_simrank(sr + ".sim.txt")
    table = ds.build_sim_table(sims, n, device=dev)
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, 10_000)
    dst = rng.integers(0, n, 10_000)
    hit = rng.random(10_000) < 0.5  # half of the pairs from the row's own list
    for i in np.flatnonzero(hit):
        if sims[src[i]]:
            dst[i] = sims[src[i]][rng.integers(len(sims[src[i]]))][0]
    want = np.array([dict(sims[s]).get(d, min((v for _, v in sims[s]), default=0.0))
                     for s, d in zip(src, dst)], np.float32)
    got = ds.lookup_sim(table, torch.from_numpy(src).to(dev),
                        torch.from_numpy(dst.astype(np.int32)[:, None]).to(dev))[:, 0]
    hits = sum(d in dict(sims[s]) for s, d in zip(src, dst))
    check(np.array_equal(got.cpu().numpy(), want), "lookup_sim on the card differs from the dict")
    out["lookup"] = dict(pairs=10_000, hits=int(hits), equal=True)
    say(f"lookup_sim on the card against a dictionary: 10,000 pairs ({hits:,} in the top-20 "
        f"lists), all equal")

    # the entry point at full width: train_deepsim's own wall per step
    g = read_edgelist_graph(path)
    walks = simulate_walks(g, 10, 80, key_for(0, 0), device=dev)
    cfg = DeepSimConfig()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds.train_deepsim(walks, table, n, cfg, key=6, steps=DEEPSIM_STEPS, device=dev, losses=losses)
    train_s = time.perf_counter() - t0  # ends with the embedding's copy to the host
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    out["train_deepsim"] = dict(steps=DEEPSIM_STEPS, wall_s=train_s,
                                ms_per_step=train_s / DEEPSIM_STEPS * 1e3,
                                cli_train_ms_per_step=stages["train"] / DEEPSIM_STEPS * 1e3)
    out["loss"] = dict(steps=DEEPSIM_STEPS, first_100_mean=first, last_100_mean=last)
    say(f"train_deepsim (V = {n:,}, B = 128, window 10, dim 128), {DEEPSIM_STEPS} steps in this "
        f"process: {train_s:.3f} s, {train_s / DEEPSIM_STEPS * 1e3:.3f} ms a step (host clock, "
        f"synchronised; the deepsim CLI's train stage "
        f"{stages['train'] / DEEPSIM_STEPS * 1e3:.3f} ms a step); mean loss of the first 100 "
        f"steps {first:.4f}, of the last 100 {last:.4f}")
    check(last < first, f"DeepSim loss did not fall: {first} -> {last}")

    # its step (the same Trainer.step) in parts: time, launches, busy share, memory
    trainer = ds.Trainer(walks, table, ds.init_params(cfg, n, key_for(0, 2), dev), cfg,
                         key_for(0, 3), dev)

    def run(steps=50):
        for _ in range(steps):
            trainer.step()

    with full_fp32():
        run()
        _, peak_gb = memory_peak_gb(run)
        ev_ms, host_ms = timed_call(run, runs=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(DEEPSIM_STEPS)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        busy, kernels = device_profile(trainer.step)
        one_host = timed_call(trainer.step, runs=5)[1]
    r = dict(v=n, walks=list(walks.shape), minibatch=cfg.minibatch, dim=cfg.dim,
             window=cfg.window, ms_per_step_events=ev_ms / 50, ms_per_step_host=host_ms / 50,
             ms_per_step_host_unbroken=long_ms / DEEPSIM_STEPS,
             device_intervals_per_step=kernels, busy_ms_one_step=busy,
             busy_share_one_step=None if busy is None else busy / one_host, peak_gb=peak_gb)
    out["step"] = r
    say(f"DeepSim Trainer.step (draws, window labels, gather, [128 x {n:,}] logits, softmax CE, "
        f"backward, Adam): {r['ms_per_step_events']:.3f} ms (CUDA events) / "
        f"{r['ms_per_step_host']:.3f} ms (host) per step over runs of 50, "
        f"{r['ms_per_step_host_unbroken']:.3f} ms (host) over one run of {DEEPSIM_STEPS}; "
        f"{kernels} device intervals a step; card "
        + ("busy not measured" if busy is None else
           f"busy {busy:.3f} ms of a {one_host:.3f} ms step ({r['busy_share_one_step']:.3f})")
        + f"; peak {peak_gb:.3f} GB above what was held")
    del trainer

    # seeded runs
    t0 = time.perf_counter()
    a = ds.train_deepsim(walks, table, n, cfg, key=5, steps=200, device=dev)
    run_s = time.perf_counter() - t0
    b = ds.train_deepsim(walks, table, n, cfg, key=5, steps=200, device=dev)
    same = bool(np.array_equal(a, b))
    out["determinism"] = dict(steps=200, run_s=run_s, two_runs_bit_equal=same)
    say(f"DeepSim: two 200-step runs with one seed bit-equal {same} ({run_s:.2f} s a run)")
    check(same, "two seeded DeepSim runs differ")
    return sr + ".sim.txt"


def sdne_oracle(params, x, minibatch, p1=0.005):
    """Literal numpy float64 transcription of the reference graph's
    formulas (SDNE/SDNE.py:88-122)."""
    def l2(a):
        return np.sum(np.square(a)) / 2.0  # tf.nn.l2_loss

    (w1, b1), (w2, b2), (w3, b3), (w4, b4) = [
        (np.asarray(w, np.float64), np.asarray(b, np.float64)) for (w, b) in params]
    x = np.asarray(x, np.float64)
    hidden1 = np.maximum(x @ w1 + b1, 0.0)            # SDNE.py:88
    answer = hidden1 @ w2 + b2                        # SDNE.py:95
    hidden2 = np.maximum(answer, 0.0)                 # SDNE.py:89
    hidden3 = np.maximum(hidden2 @ w3 + b3, 0.0)      # SDNE.py:90
    y = hidden3 @ w4 + b4                             # SDNE.py:94
    recon = np.mean(l2(y - x) / (1.0 * minibatch))    # :104
    reg1 = sum(l2(a) for pair in [(w1, b1), (w2, b2), (w3, b3), (w4, b4)] for a in pair)
    sumq = np.mean(hidden2)                           # :115
    reg2 = p1 * np.log(p1 / (sumq + 1e-8)) + (1.0 - p1) * np.log(
        (1.0 - p1) / (1.0 - sumq + 1e-8))             # :116
    return {"hidden1": hidden1, "answer": answer, "hidden2": hidden2, "hidden3": hidden3,
            "y": y, "recon": recon, "reg1": reg1, "reg2": reg2,
            "total": recon + 1e-1 * reg1 + 1e-1 * reg2}


def phase_sdne(dev, tmp, report):
    """SDNE: the reference net on the card against the float64 oracle, the
    step at the blog shape, and the ``sdne`` CLI on the blog edge file."""
    from graphtpu_torch.core.config import SDNEConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.core.graph import dense_adjacency, read_edgelist_graph
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.io.embfile import read_emb
    from graphtpu_torch.models import sdne

    out = report.setdefault("sdne", {})
    cfg = SDNEConfig()
    params = sdne.init_params(cfg, key_for(0, 0), dev)
    x = torch.from_numpy(np.random.default_rng(0).random((100, 784), dtype=np.float32)).to(dev)
    with torch.no_grad(), full_fp32():
        acts = sdne.forward(params, x)
        total, terms = sdne.loss_fn(params, x, cfg)
    ref = sdne_oracle([(w.cpu().numpy(), b.cpu().numpy()) for w, b in params], x.cpu().numpy(),
                      cfg.minibatch, cfg.sparsity_p)
    errs = {}
    for name in ("hidden1", "answer", "hidden2", "hidden3", "y"):
        scale = max(1.0, float(np.abs(ref[name]).max()))
        errs[name] = float(np.abs(acts[name].double().cpu().numpy() - ref[name]).max()) / scale
        check(errs[name] <= TOL_SDNE_ACT, f"SDNE {name}: {errs[name]} > {TOL_SDNE_ACT}")
    terms = dict(terms, total=total)
    for name, tol in (("recon", 1e-4), ("reg1", 1e-4), ("reg2", 1e-3), ("total", 1e-4)):
        errs[name] = abs(terms[name].item() - ref[name]) / abs(ref[name])
        check(errs[name] <= tol, f"SDNE {name}: relative error {errs[name]} > {tol}")
    out["reference_net"] = dict(units=list(cfg.units), batch=100, rel_errors=errs)
    say("SDNE reference net [784, 400, 100, 300, 784] on the card against the float64 oracle: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (activations / max(1, |ref|) <= {TOL_SDNE_ACT:g}; terms relative <= 1e-4, "
          "KL 1e-3)")

    # the step at the blog shape (the CLI's input: rows of the dense adjacency)
    path = os.path.join(tmp, "blog_ds.txt")
    g = read_edgelist_graph(path)
    adj = dense_adjacency(g, device=dev)
    v = adj.shape[0]
    bcfg = SDNEConfig(units=(v, 400, 100, 300, v))
    init = sdne.init_params(bcfg, key_for(0, 1), dev)
    trainer = sdne.Trainer(adj, init, bcfg, dev)

    def run(steps=50):
        for _ in range(steps):
            trainer.step()

    with full_fp32():
        run()
        _, peak_gb = memory_peak_gb(run)
        ev_ms, host_ms = timed_call(run, runs=3)
    del trainer
    # the entry point in this process: train_sdne's own wall per step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdne.train_sdne(adj, bcfg, steps=SDNE_STEPS, params=init, device=dev)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) / SDNE_STEPS * 1e3
    del init, adj
    emb = os.path.join(tmp, "blog_sdne.emb")
    wall, stdout = run_cli(["sdne", "--input", path, "--output", emb])
    stages = stages_of(stdout)
    with open(emb) as f:
        header = f.readline().split()
    _, vecs = read_emb(emb)
    check(header == [str(v), "100"] and vecs.shape == (v, 100) and bool(np.isfinite(vecs).all()),
          f"sdne CLI: header {header}, rows {vecs.shape}")
    out["step"] = dict(units=list(bcfg.units), minibatch=100, ms_per_step_events=ev_ms / 50,
                       ms_per_step_host=host_ms / 50, peak_gb=peak_gb)
    out["train_sdne"] = dict(steps=SDNE_STEPS, ms_per_step=train_ms,
                             cli_train_ms_per_step=stages["train"] / 2000 * 1e3)
    out["cli"] = dict(wall_s=wall, steps=2000, stages_s=stages, rows=v, dim=100)
    say(f"SDNE Trainer.step at blog (units [{v:,}, 400, 100, 300, {v:,}], minibatch 100): "
        f"{ev_ms / 50:.3f} ms (CUDA events) / {host_ms / 50:.3f} ms (host) per step over 50; "
        f"train_sdne in this process {train_ms:.3f} ms a step over {SDNE_STEPS} (host clock, "
        f"synchronised); peak {peak_gb:.3f} GB above the adjacency; sdne CLI (2,000 steps) "
        f"{wall:.2f} s wall ({stages['train'] / 2000 * 1e3:.3f} ms a train step), "
        + ", ".join(f"{k} {x:.3f} s" for k, x in stages.items())
        + f"; .emb {' '.join(header)}, all finite")


def le_residuals(w, y, evals, guard):
    """max over kept eigenpairs of ||(D - W)y - lambda D y|| / ||D y||, in
    float64 on the host."""
    w = np.asarray(w, np.float64)
    d = w.sum(axis=1) + guard
    res = []
    for lam, col in zip(evals, np.asarray(y, np.float64).T):
        dy = d * col
        res.append(float(np.linalg.norm(dy - w @ col - lam * dy) / np.linalg.norm(dy)))
    return res


def phase_le(dev, tmp, blog_sims, report):
    """Laplacian Eigenmaps: the ``le`` CLI on the swiss roll, the blog
    ``.sim.txt`` and R-MAT scale 11's, each kept eigenpair's residual, and
    R-MAT's spectrum against scipy's float64 ``eigh``."""
    import scipy.linalg

    from graphtpu_torch.bench.generators import rmat_graph
    from graphtpu_torch.io.edgelist import write_edgelist
    from graphtpu_torch.io.simfile import read_sim_file
    from graphtpu_torch.models import lapeigen as le

    out = report.setdefault("le", {})
    rpath = os.path.join(tmp, "rmat11_le.txt")
    write_edgelist(rpath, rmat_graph(scale=11, n_edges=41_000, seed=0))
    rsr = os.path.join(tmp, "rmat11_sr")
    _, launched, sr_err = simrank_cli_checked(dev, rpath, rsr, "R-MAT 11, for LE")
    out["rmat11_simrank"] = dict(launches=launched, file_err_vs_dense=sr_err)
    say(f"simrank CLI on R-MAT 11: kernel launches {launched}, file top-20 vs the dense engine "
        f"{sr_err:.3e} (bound {TOL_SIM_F32:g})")
    cases = (("swiss roll", None), ("blog", blog_sims), ("rmat11", rsr + ".sim.txt"))
    for tag, sim_path in cases:
        npy = os.path.join(tmp, f"le_{tag.replace(' ', '_')}.npy")
        argv = ["le", "--output", npy] + ([] if sim_path is None else ["--input", sim_path])
        wall, stdout = run_cli(argv)
        line = stdout.strip().splitlines()[-1]
        evals = [float(e) for e in line.split("eigenvalues ")[1].split(";")[0].split()]
        stages = stages_of(stdout)
        y = np.load(npy)
        if sim_path is None:
            pts = torch.from_numpy(le.make_swiss_roll(2000)).to(dev)
            w, guard = le.knn_heat_affinity(pts, 10, 15.0).cpu().numpy(), 0.0
        else:
            sims = read_sim_file(sim_path)
            nn = max(max(sims), max(d for ps in sims.values() for d, _ in ps)) + 1
            w, guard = le.sim_dict_affinity(sims, nn), 1e-6
        res = le_residuals(w, y, evals, guard)
        row = dict(n=int(w.shape[0]), kept_eigenvalues=evals, residuals=res, wall_s=wall,
                   stages_s=stages)
        check(len(evals) == 2 and min(evals) > 1e-5 and y.shape == (w.shape[0], 2)
              and bool(np.isfinite(y).all()), f"le {tag}: eigenvalues {evals}, Y {y.shape}")
        check(max(res) < TOL_LE_RESIDUAL, f"le {tag}: residuals {res}")
        if tag == "blog":
            # the smallest eigenvalues in float64 (LAPACK on the host): is the
            # first kept pair the component's zero, lifted by float32 rounding?
            d64 = w.astype(np.float64).sum(axis=1) + guard
            di = 1.0 / np.sqrt(d64)
            t0 = time.perf_counter()
            low = scipy.linalg.eigh(np.eye(len(d64)) - di[:, None] * w * di[None, :],
                                    eigvals_only=True, subset_by_index=[0, 3], driver="evr")
            row.update(smallest_f64=[float(x) for x in low],
                       f64_subset_s=time.perf_counter() - t0)
        if tag == "rmat11":
            wt = torch.from_numpy(w).to(dev)
            lsym, _ = le.normalized_laplacian(wt, guard)
            spec = torch.linalg.eigh(lsym)[0].cpu().numpy()
            ms = cuda_ms(lambda: torch.linalg.eigh(lsym), warmup=1, runs=3)
            d64 = w.astype(np.float64).sum(axis=1) + guard
            di = np.where(d64 > 0, 1.0 / np.sqrt(np.maximum(d64, 1e-30)), 0.0)
            ref = scipy.linalg.eigh(np.eye(len(d64)) - di[:, None] * w * di[None, :],
                                    eigvals_only=True)
            spec_err = float(np.abs(spec - ref).max())
            kept = spec[spec > 1e-5][:2]
            kept_err = float(np.abs(np.asarray(evals) - ref[spec > 1e-5][:2]).max())
            row.update(spectrum_max_abs_err_vs_scipy_f64=spec_err, kept_vs_scipy=kept_err,
                       zero_eigenvalues_f64=int((ref < 1e-9).sum()),
                       near_floor_f32=[float(x) for x in spec[(spec > -1e-4) & (spec < 1e-4)]],
                       eigh_cuda_ms=ms)
            check(np.allclose(kept, evals, rtol=0, atol=1e-6),
                  f"le rmat11: the CLI kept {evals}, the spectrum {kept}")
            check(spec_err <= TOL_LE_EIGH, f"le rmat11: spectrum vs scipy {spec_err}")
            check(kept_err <= TOL_LE_EIGH, f"le rmat11: kept vs scipy {kept_err}")
        out[tag] = row
        say(f"le {tag} (n = {w.shape[0]:,}): {wall:.2f} s wall in a subprocess, "
            + ", ".join(f"{k} {x:.3f} s" for k, x in stages.items())
            + f"; kept eigenvalues {evals}; residuals {[f'{r:.2e}' for r in res]} "
              f"(bound {TOL_LE_RESIDUAL:g})"
            + ("" if tag != "blog" else f"; the 4 smallest eigenvalues in float64 "
               f"{[f'{x:.3e}' for x in row['smallest_f64']]} (reported)")
            + ("" if tag != "rmat11" else
               f"; spectrum vs scipy float64 max |err| {row['spectrum_max_abs_err_vs_scipy_f64']:.2e},"
               f" kept {row['kept_vs_scipy']:.2e} (bound {TOL_LE_EIGH:g}); "
               f"{row['zero_eigenvalues_f64']} zero eigenvalues in float64; eigh alone "
               f"{ms:.1f} ms (CUDA events)"))


def phase_support(dev, tmp, report):
    """BFS, weight statistics, the C++ parser, the C++ generator and the CSR
    cache."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    from graphtpu_torch import build_graph, load_graph_cached
    from graphtpu_torch.core import stats
    from graphtpu_torch.core.reorder import bfs_order, locality_score
    from graphtpu_torch.core.traversal import bfs_distances
    from graphtpu_torch.io.edgelist import read_edgelist, read_edgelist_numpy
    from graphtpu_torch.native import load

    out = report.setdefault("support", {})
    edges = blog_shaped_edges()
    g = build_graph(edges, n_nodes=BLOG_NODES, device=dev)
    rp, col, _, _ = g.host
    src = np.random.default_rng(9).choice(BLOG_NODES, 64, replace=False).astype(np.int32)
    t0 = time.perf_counter()
    got = bfs_distances(g, src, device=dev)
    bfs_s = time.perf_counter() - t0
    a = sp.csr_matrix((np.ones(len(col)), col, rp), shape=(BLOG_NODES, BLOG_NODES))
    ref = shortest_path(a, unweighted=True, indices=src)
    want = np.where(np.isinf(ref), -1, ref).astype(np.int32)
    check(np.array_equal(got, want), "BFS distances differ from scipy's")
    out["bfs"] = dict(sources=64, seconds=bfs_s, max_dist=int(got.max()),
                      unreachable=int((got < 0).sum()))
    say(f"BFS from 64 blog sources on the card: {bfs_s:.3f} s, equal to scipy's shortest_path "
        f"(max distance {got.max()}, {int((got < 0).sum()):,} unreachable pairs)")

    # the host-side API on the card-resident graph, against its card CSR
    check(g.device.type == "cuda", f"the blog graph lives on {g.device}")
    rp_d, col_d, deg_d = g.row_ptr.cpu().numpy(), g.col.cpu().numpy(), g.deg.cpu().numpy()
    hub = int(np.argmax(deg_d))
    nodes = sorted({0, hub, BLOG_NODES // 2, int(np.argmin(deg_d)), BLOG_NODES - 1, *src[:4]})
    for v in nodes:
        nb = g.neighbors(v)
        check(nb.dtype == np.int32 and np.array_equal(nb, col_d[rp_d[v]: rp_d[v + 1]])
              and np.array_equal(nb, col[rp[v]: rp[v + 1]]), f"neighbors({v}) differ from the CSR")
        check(g.degree(v) == int(deg_d[v]) == len(nb), f"degree({v}) differs from the CSR")
    t0 = time.perf_counter()
    order = bfs_order(g, start=hub)
    order_s = time.perf_counter() - t0
    dist = bfs_distances(g, np.array([hub], np.int32), device=dev)[0]
    reach = int((dist >= 0).sum())
    check(order[0] == hub and np.array_equal(np.sort(order), np.arange(BLOG_NODES)),
          "bfs_order(start=hub) is no permutation seeded at the hub")
    check(bool((dist[order[:reach]] >= 0).all()) and bool((np.diff(dist[order[:reach]]) >= 0).all()),
          "bfs_order(start=hub) does not visit the hub's component in BFS layers")
    hits = int((torch.diff(g.col.long()).abs() <= 2).sum())
    score = locality_score(g, window=2)
    check(abs(score - hits / (g.n_edges - 1)) <= 1e-12,
          f"locality_score(window=2) {score} differs from the card's {hits / (g.n_edges - 1)}")
    out["api"] = dict(nodes=len(nodes), bfs_order_s=order_s, reached=reach, locality_w2=score)
    say(f"neighbors/degree of {len(nodes)} nodes equal the card's CSR; bfs_order(start=hub) "
        f"{order_s:.3f} s (host), its first {reach:,} nodes in the hub's BFS layers; "
        f"locality_score(window=2) {score:.4f}, equal to the card's count")

    wts = np.random.default_rng(10).uniform(0.1, 1.1, len(edges)).astype(np.float32)
    gw = build_graph(edges, wts, n_nodes=BLOG_NODES, device=dev)
    rp, _, w, deg = gw.host
    seg = np.repeat(np.arange(BLOG_NODES), deg)
    s1 = np.bincount(seg, w.astype(np.float64), BLOG_NODES)
    s2 = np.bincount(seg, w.astype(np.float64) ** 2, BLOG_NODES)
    d = np.maximum(deg, 1)
    var = np.where(deg > 0, s2 / d - (s1 / d) ** 2, 0.0)
    errs = {}
    for name, fn, ref in (("out_weight_sums", stats.out_weight_sums, s1),
                          ("out_weight_variance", stats.out_weight_variance, var)):
        x1, x2 = fn(gw).cpu().numpy(), fn(gw).cpu().numpy()
        errs[name] = float(np.abs(x1 - ref).max() / np.abs(ref).max())
        check(np.array_equal(x1, x2), f"{name}: two runs differ")
        check(errs[name] <= TOL_STATS, f"{name}: {errs[name]} > {TOL_STATS}")
    out["stats"] = dict(rel_errors=errs, bit_equal=True)
    say("weight statistics on the weighted blog graph against numpy float64: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {TOL_STATS:g} of the "
        "largest), two runs bit-equal")

    path = os.path.join(tmp, "blog_ds.txt")
    load()  # built by the CLIs' reads; bound here, so the timing is the parse alone
    t0 = time.perf_counter()
    cpp = read_edgelist(path)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npy = read_edgelist_numpy(path)
    np_s = time.perf_counter() - t0
    check(np.array_equal(cpp[0], npy[0]) and cpp[1] is None and npy[1] is None,
          "the C++ parser and the numpy reader disagree on the blog file")
    out["parser"] = dict(edges=int(len(cpp[0])), cpp_s=cpp_s, numpy_s=np_s)
    say(f"blog edge file ({len(cpp[0]):,} lines): C++ parser {cpp_s * 1e3:.1f} ms, numpy reader "
        f"{np_s * 1e3:.1f} ms (host), the same edges")

    mpath = os.path.join(tmp, "massive.txt")
    nl, nr, deg_avg = MASSIVE
    wall, stdout = run_cli(["generate", "--output", mpath, "--kind", "massive", "--nodes",
                            str(nl), "--right", str(nr), "--avg-degree", str(deg_avg)])
    target = (nl + nr) * deg_avg // 2
    check(stdout.strip().endswith(f": {target} edges"), f"generate: {stdout.strip()}")
    t0 = time.perf_counter()
    me, _ = read_edgelist(mpath)
    mread_s = time.perf_counter() - t0
    keys = np.unique(me[:, 0] * (nl + nr) + me[:, 1])
    check(len(me) == target == len(keys), f"generate: {len(me)} lines, {len(keys)} distinct")
    check(me[:, 0].min() >= 0 and me[:, 0].max() < nl and me[:, 1].min() >= nl
          and me[:, 1].max() < nl + nr, "generate: ids out of range")
    t0 = time.perf_counter()
    first = load_graph_cached(mpath, n_nodes=nl + nr)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = load_graph_cached(mpath, n_nodes=nl + nr)
    second_s = time.perf_counter() - t0
    check(all(np.array_equal(x, y) for x, y in zip(first.host, second.host) if x is not None),
          "load_graph_cached: the second touch differs from the first")
    out["generate"] = dict(n_left=nl, n_right=nr, edges=target, wall_s=wall, read_s=mread_s)
    out["csr_cache"] = dict(slots=int(first.n_edges), first_s=first_s, second_s=second_s)
    say(f"generate --kind massive (C++): {target:,} distinct bipartite edges on {nl:,} + {nr:,} "
        f"nodes in {wall:.2f} s wall, read back in {mread_s:.2f} s; load_graph_cached "
        f"({first.n_edges:,} slots): first touch {first_s:.2f} s, second {second_s:.2f} s, "
        "the same CSR")


DIST_RANKS = 4           # phase 18: gloo ranks sharing the card
DIST_SOURCES = 1024      # reuse UniWalk and TopSim sources
DIST_WALKS = 10          # node2vec hops of the distributed walks (4 per non-isolated node)
TOL_DIST_BF16_ULPS = 4   # the bf16 ring vs the tree path's bf16 run (tests/test_torch_dist_cuda.py)
TOL_SGNS_DP = 1e-5       # train_sgns_dp vs train_sgns on the same batches
FLAGSHIP = dict(v=10_000_000, avg_deg=8, sample=10_000, times=4, stop_v=3 * 4096,
                window=4096, tile=2048)
SGNS_MESHES = ((4, 1), (2, 2), (1, 4))  # phase 18's (data, model) meshes for the SGNS epoch
SGNS_COLS = ("wall_s", "steps", "table_bytes", "peak_gb", "wire_bytes_per_step",
             "lookup_ms", "compute_ms", "update_ms", "err", "finite")


def tensor_max(x: torch.Tensor) -> float:
    """The largest entry, 0 for an empty tensor (a rank's block past V)."""
    return float(x.max()) if x.numel() else 0.0


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| in bf16 ulps of ref (ref == 0 must be exact)."""
    d = (got.float() - ref.float()).abs().double()
    ulp = bf16_ulp(ref.float())
    return tensor_max(torch.where(ref != 0, d / ulp.clamp(min=1e-300), d * 1e30))


def tree_plain(tree, x):
    """``tree_spmm(tree, x)`` by the plain version of B3, level by level."""
    from graphtpu_torch.kernels import spmm

    last = len(tree.levels) - 1
    for k in range(last + 1):
        sl, w = tree.levels[k], tree.weights[k]
        if k == last:
            sl, w = sl[: tree.n_nodes], w[: tree.n_nodes]
        x = spmm.gather_rows_sum_plain(sl, w, x)
    return x


def b3_at_rank(it, seed):
    """B3 at the shapes a sharded product gives it on this rank: the rank's
    local tree through ``tree_spmm`` against the plain chain on the same
    tree, over the first block the ring multiplies (``it.init()``) and a
    seeded block of its shape and dtype; (max |err|, unequal elements)."""
    from graphtpu_torch.kernels import spmm

    first = it.init()
    gen = torch.Generator(device=first.device).manual_seed(seed)
    rand = torch.rand(first.shape, generator=gen, device=first.device).to(first.dtype)
    err, unequal = 0.0, 0
    for x in (first, rand):
        got, want = spmm.tree_spmm(it.tree, x), tree_plain(it.tree, x)
        err = max(err, tensor_max((got - want).abs()))
        unequal += int((got != want).sum())
    return err, unequal


def _dist_rank(device):
    """Phase 18 on one rank: every dist form on the blog-shaped graph, each
    checked on this rank's device against the single-device path; returns
    (rank 0) the numbers of every rank."""
    import torch.distributed as dist

    from graphtpu_torch.core.config import SGNSConfig, SimRankConfig, TopSimConfig, UniWalkConfig
    from graphtpu_torch.dist import mesh as dm
    from graphtpu_torch.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu_torch.dist.sgns_dp import train_sgns_dp
    from graphtpu_torch.dist.sharded_graph import shard_graph
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.dist.spmm_sharded import make_sharded_iter, sharded_simrank_spmm
    from graphtpu_torch.dist.spmm_summa import make_summa_iter, summa_simrank_spmm
    from graphtpu_torch.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu_torch.dist.uniwalk_dist import distributed_uniwalk_simrank_reuse
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.kernels.sampling import edge_exists
    from graphtpu_torch.models.sgns import train_sgns
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm
    from graphtpu_torch.simrank.topsim import topsim_simrank
    from graphtpu_torch.simrank.uniwalk import uniwalk_simrank_reuse_topk
    from graphtpu_torch.walks.walker import uniform_walks

    n = dist.get_world_size()
    mesh = dm.make_1d_mesh(device=device)
    dev, grp = mesh.device, mesh.groups["data"]
    grid = dm.make_2d_mesh(2, 2, device=device) if n == 4 else dm.make_2d_mesh(1, 1, device=device)
    g = blog_shaped_graph()
    v = g.n_nodes
    cfg = SimRankConfig(iterations=ITERATIONS)
    out = {"backend": mesh.backend, "ranks": n, "grid": list(grid.shape)}

    def everyone(row):
        return dm.all_gather(torch.tensor(row, dtype=torch.float64, device=dev), grp).cpu().numpy()

    forms = {
        "ring_f32": lambda st: sharded_simrank_spmm(g, mesh, cfg, stage_times=st),
        "ring_bf16": lambda st: sharded_simrank_spmm(g, mesh, cfg, dtype=torch.bfloat16,
                                                     stage_times=st),
        "summa_f32": lambda st: summa_simrank_spmm(g, grid, cfg, stage_times=st),
        "dense": lambda st: sharded_exact_simrank(g, mesh, cfg, stage_times=st),
    }
    blocks, rows = {}, {}
    for name, fn in forms.items():
        st = {}
        dist.barrier()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        spmm.GATHER_LAUNCHES["gather_rows_sum"] = 0
        t0 = time.perf_counter()
        blocks[name] = fn(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = spmm.GATHER_LAUNCHES["gather_rows_sum"]
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        per = [st.get(k, 0.0) / cfg.iterations for k in ("b3", "wire", "local")]
        rows[name] = [(1e3 * wall - st["plan"]) / cfg.iterations,
                      st.get("matmul", 0.0) / cfg.iterations if name == "dense" else per[0],
                      per[1], per[2], launches, peak, st["plan"]]
    # the single-device references on this rank's device, one at a time
    refs = {"ring_f32": lambda: exact_simrank_spmm(g, cfg, impl="tree", device=dev),
            "ring_bf16": lambda: exact_simrank_spmm(g, cfg, impl="tree", dtype=torch.bfloat16,
                                                    device=dev),
            "dense": lambda: exact_simrank(g, cfg, device=dev)}
    refs["summa_f32"] = refs["ring_f32"]
    # B3 on this rank's local tree and blocks, against its plain version
    # (after the counts were read: these launches are not the path's)
    iters = {"ring_f32": lambda: make_sharded_iter(g, mesh, cfg),
             "ring_bf16": lambda: make_sharded_iter(g, mesh, cfg, dtype=torch.bfloat16),
             "summa_f32": lambda: make_summa_iter(g, grid, cfg)}
    for name in forms:
        ref = refs[name]()
        b = blocks.pop(name)
        r = ref[b.row_lo: b.row_lo + b.values.shape[0], b.col_lo: b.col_lo + b.values.shape[1]]
        err = (bf16_ulps(b.values, r) if name == "ring_bf16"
               else tensor_max((b.values.float() - r.float()).abs()))
        del ref, r, b
        b3 = b3_at_rank(iters[name](), 7 + mesh.rank) if name in iters else (0.0, 0)
        torch.cuda.empty_cache()
        out[name] = everyone(rows[name] + [err, *b3])  # [rank, DIST_COLS]

    # distributed node2vec walks (p = 1, q = 2), every transition an edge
    sg = shard_graph(g, n, mesh=mesh)
    live = np.nonzero(g.host[3] > 0)[0].astype(np.int32)
    starts = np.tile(live, 4)
    t0 = time.perf_counter()
    wl = distributed_node2vec_walks(sg, len(starts), DIST_WALKS, 1.0, 2.0, 11, mesh, starts=starts)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    walks = dm.gather_rows(wl, grp)
    gd = g.to(dev)
    a, b = walks[:, :-1], walks[:, 1:]
    bad = ((b >= 0) & ~edge_exists(gd, a, b)).sum().item()
    out["node2vec"] = dict(walkers=len(starts), hops=DIST_WALKS, s=walk_s, bad=bad,
                           dead=float((walks < 0).float().mean()))

    # reuse UniWalk on injected walks from 1,024 sources, against the
    # single-device reuse top-k on the same walks
    rcfg = UniWalkConfig(sample=2000, step=5, reuse_times=4, topk=20)
    src = torch.arange(DIST_SOURCES, dtype=torch.int32, device=dev)
    rw = uniform_walks(gd, torch.repeat_interleave(src, rcfg.sample // 4), 2 * 5 + 3, 17,
                       device=dev)
    t0 = time.perf_counter()
    dv, di = distributed_uniwalk_simrank_reuse(sg, mesh, rcfg, walks=rw)
    reuse_s = time.perf_counter() - t0
    sv, si = uniwalk_simrank_reuse_topk(gd, rcfg, walks=rw, device=dev)
    tie = (np.abs(sv - np.roll(sv, 1, 1)) <= TOL_MC_PARITY) | (np.abs(sv - np.roll(sv, -1, 1))
                                                               <= TOL_MC_PARITY)
    out["reuse"] = dict(sources=DIST_SOURCES, walks=int(rw.shape[0]), s=reuse_s,
                        max_abs_err=float(np.abs(dv - sv).max()),
                        ids_ok=bool(((di == si) | tie).all()))
    del rw

    # TopSim over the partitioned CSR on 1,024 sources in the even-split
    # regime (mass >= degree at every expansion: no sampling), against the
    # single-device engine's dense rows
    tcfg = TopSimConfig(sample=1e5, step=1, topk=20, source_tile=32, frontier_capacity=16384)
    sources = np.arange(DIST_SOURCES, dtype=np.int32)
    t0 = time.perf_counter()
    tv, ti = distributed_topsim_simrank(sg, mesh, tcfg, key=19, sources=sources,
                                        device_capacity=1 << 20)
    topsim_s = time.perf_counter() - t0
    dense = topsim_simrank(gd, tcfg, key=19, sources=sources, dense=True, device=dev)
    err, ok = ranked_close(tv, ti, dense, TOL_MC_PARITY)
    out["topsim"] = dict(sources=DIST_SOURCES, s=topsim_s, max_abs_err=err, ok=ok)
    del dense

    # one data-parallel SGNS epoch on the gathered walks, against one card
    scfg = SGNSConfig(epochs=1)
    t0 = time.perf_counter()
    d0, d1 = train_sgns_dp(walks, v, mesh, scfg)
    sgns_s = time.perf_counter() - t0
    s0, s1 = train_sgns(walks, v, scfg, device=dev)
    out["sgns"] = dict(s=sgns_s, slots=int(walks.numel()),
                       max_abs_err=float(max(np.abs(d0 - s0).max(), np.abs(d1 - s1).max())),
                       finite=bool(np.isfinite(d0).all()))
    # the same epoch with the tables row-sharded over a model axis, beside
    # the data-only mesh (every mesh timed with its stages synchronised)
    if n == DIST_RANKS:
        for shape in SGNS_MESHES:
            m = dm.make_mesh(model_parallel=shape[1], device=device) if shape[1] > 1 else mesh
            st = {}
            dist.barrier()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            m0, m1 = train_sgns_dp(walks, v, m, scfg, stage_times=st)
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            steps = st["steps"]
            err = float(max(np.abs(m0 - s0).max(), np.abs(m1 - s1).max()))
            out[f"sgns_{shape[0]}x{shape[1]}"] = everyone(
                [wall, steps, st["table_bytes"], peak,
                 (st["lookup_bytes"] + st["update_bytes"]) / steps, st["lookup"] / steps,
                 st["compute"] / steps, st["update"] / steps, err, float(np.isfinite(m0).all())])
    return out


DIST_COLS = ("iter_ms", "local_product_ms", "wire_ms", "transpose_ms", "b3_launches", "peak_gb",
             "plan_ms", "err", "b3_vs_plain", "b3_unequal")


def phase_dist(dev, report):
    """dist on the card: DIST_RANKS gloo ranks, then one NCCL rank; returns
    B3's launches over every rank's sharded products and B3's largest
    error against its plain version at those products' shapes."""
    from graphtpu_torch.dist.mesh import spawn

    card = card_line()
    out = report.setdefault("dist", {"card": card})
    total, b3_err = 0, 0.0
    for n, backend in ((DIST_RANKS, "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        res = spawn(_dist_rank, n, backend, "cuda", timeout=600)
        wall = time.perf_counter() - t0
        tag = f"{n} {backend} rank{'s' if n > 1 else ''}"
        run = {"wall_s": wall, "backend": res["backend"], "grid": res["grid"]}
        for name in ("ring_f32", "ring_bf16", "summa_f32", "dense"):
            per = res[name]
            rec = {c: per[:, k].tolist() for k, c in enumerate(DIST_COLS)}
            run[name] = rec
            launches = per[:, 4]
            err = float(per[:, 7].max())
            bf16 = name == "ring_bf16"
            say(f"dist {tag}, {name}{' ' + 'x'.join(map(str, res['grid'])) if 'summa' in name else ''}"
                f" ({card}): per iteration {per[:, 0].mean():.2f} ms (ranks' mean; "
                f"{'matmuls' if name == 'dense' else 'B3'} {per[:, 1].mean():.2f}, wire "
                f"{per[:, 2].mean():.2f}, transposes {per[:, 3].mean():.2f}; the plan before it "
                f"{per[:, 6].mean():.1f} ms); B3 launches per rank "
                f"{launches.astype(int).tolist()}; peak GB per rank "
                + ", ".join(f"{x:.3f}" for x in per[:, 5])
                + f"; vs the single-device {'dense engine' if name == 'dense' else 'tree path'} "
                + (f"{err:.2f} bf16 ulps (bound {TOL_DIST_BF16_ULPS})" if bf16
                   else f"{err:.3e} (bound {TOL_F32_DIST:g})"))
            if name == "dense":
                check(err <= TOL_F32_DIST, f"dist {tag} dense: {err}")
                continue
            plain_err = float(per[:, 8].max())
            say(f"dist {tag}, {name}: B3 on each rank's local tree, over its first block and a "
                f"seeded one of that shape, vs the plain version {plain_err:.3e} (bound "
                f"{TOL_B3:g}); unequal elements per rank {per[:, 9].astype(int).tolist()}")
            check(plain_err <= TOL_B3, f"dist {tag} {name}: B3 vs plain {plain_err} > {TOL_B3}")
            b3_err = max(b3_err, plain_err)
            check((launches > 0).all(), f"dist {tag} {name}: B3 not launched in every rank")
            check(err <= (TOL_DIST_BF16_ULPS if bf16 else TOL_F32_DIST), f"dist {tag} {name}: {err}")
            total += int(launches.sum())
        nv, ru, ts, sg = res["node2vec"], res["reuse"], res["topsim"], res["sgns"]
        say(f"dist {tag} ({card}): node2vec p=1 q=2 {nv['walkers']:,} walkers x {nv['hops']} hops "
            f"{nv['s']:.2f} s, {nv['bad']} non-edges, dead share {nv['dead']:.4f}; reuse UniWalk "
            f"{ru['sources']:,} sources ({ru['walks']:,} walks) {ru['s']:.2f} s, vs one card "
            f"{ru['max_abs_err']:.2e}; TopSim (even splits) {ts['sources']:,} sources "
            f"{ts['s']:.2f} s, vs one card's dense rows {ts['max_abs_err']:.2e}; SGNS epoch "
            f"{sg['s']:.2f} s ({sg['slots']:,} slots), vs one card {sg['max_abs_err']:.2e}; "
            f"spawn to end {wall:.1f} s")
        check(nv["bad"] == 0, f"dist {tag}: {nv['bad']} walk transitions are not edges")
        check(nv["dead"] == 0.0, f"dist {tag}: walkers died on a graph with no dead end")
        check(ru["max_abs_err"] <= TOL_MC_PARITY and ru["ids_ok"], f"dist {tag}: reuse vs one card")
        check(ts["ok"], f"dist {tag}: TopSim vs one card {ts['max_abs_err']}")
        check(sg["finite"] and sg["max_abs_err"] <= TOL_SGNS_DP, f"dist {tag}: SGNS vs one card")
        run.update(node2vec=nv, reuse=ru, topsim=ts, sgns=sg)
        for shape in SGNS_MESHES if n == DIST_RANKS else ():
            key = f"sgns_{shape[0]}x{shape[1]}"
            per = res[key]
            rec = {c: per[:, k].tolist() for k, c in enumerate(SGNS_COLS)}
            run[key] = rec
            say(f"dist {tag}, SGNS epoch on a ({shape[0]}, {shape[1]}) (data, model) mesh "
                f"({card}): {per[0, 0]:.2f} s wall, {int(per[0, 1])} steps; per step lookup "
                f"{per[:, 5].mean():.2f} ms, compute {per[:, 6].mean():.2f}, update "
                f"{per[:, 7].mean():.2f} (ranks' mean, synchronised stages); tables per rank "
                + ", ".join(f"{x / 1e6:.2f}" for x in per[:, 2]) + " MB; peak per rank "
                + ", ".join(f"{x:.3f}" for x in per[:, 3]) + " GB; into the all-reduces per "
                "step per rank " + ", ".join(f"{x / 1e6:.2f}" for x in per[:, 4])
                + f" MB; vs one card {per[:, 8].max():.2e} (bound {TOL_SGNS_DP:g})")
            check(bool((per[:, 9] == 1).all()) and per[:, 8].max() <= TOL_SGNS_DP,
                  f"dist {tag}: SGNS on a {shape} mesh vs one card {per[:, 8].max()}")
        out[f"{backend}_{n}"] = run
    return total, b3_err


def phase_flagship(dev, tmp, report):
    """The 10M flagship: two windows stopped by the window budget, then a
    resumed run for the third; every source once."""
    from graphtpu_torch.bench.flagship import run_flagship
    from graphtpu_torch.dist import windows

    card = card_line()
    kw = dict(FLAGSHIP, graph_path=os.path.join(tmp, "g.txt"), out_dir=os.path.join(tmp, "out"),
              device=dev, log=lambda m: say(f"  {m}"))
    # keep the float top-k each window computes beside the 6-decimal part
    # files (run_flagship looks the sweep up when it is called)
    computed, sweep = {}, windows.windowed_topk_sweep

    def recording_sweep(compute_tile, *a, **k):
        def tile(sources, key):
            vals, idx = compute_tile(sources, key)
            computed.update(zip(sources.tolist(), zip(vals, idx)))
            return vals, idx
        return sweep(tile, *a, **k)

    windows.windowed_topk_sweep = recording_sweep
    try:
        first = run_flagship(**kw, window_budget=2)
        check(not first["complete"] and first["windows_done"] == 2,
              "flagship: not stopped after 2")
        second = run_flagship(**kw)
    finally:
        windows.windowed_topk_sweep = sweep
    check(second["complete"] and second["windows_done"] == 1, "flagship: the resume did not end")
    merged = windows.read_sweep_results(kw["out_dir"])
    n = FLAGSHIP["stop_v"]
    check(sorted(merged) == list(range(n)) and sorted(computed) == list(range(n)),
          "flagship: a source is missing or repeated")
    v = FLAGSHIP["v"]
    with np.load(kw["graph_path"] + ".csr.npz") as z:
        deg, row_ptr, col = z["deg"], z["row_ptr"], z["col"]
    bad, kept, stars = [], [], 0
    for s, p in merged.items():
        vals, idx = computed[s]
        keep = idx >= 0
        x = vals[keep].astype(np.float64)
        # a walk from s meets another node at an even step unless s has no
        # edge or every neighbour's only neighbour is s (an isolated star,
        # or an isolated edge): there the exact SimRank row is empty too
        nbrs = col[row_ptr[s]: row_ptr[s + 1]]
        reach = bool((deg[nbrs] > 1).any())
        stars += not reach
        ok = (bool(p) == reach and [i for i, _ in p] == idx[keep].tolist()
              and all(0 <= i < v and i != s for i, _ in p)
              and bool(np.all(x > 0) and np.all(np.diff(x) <= 0))
              and all(abs(f - y) <= 5e-7 + 1e-12 for (_, f), y in zip(p, x)))
        kept.append(x)
        if not ok:
            bad.append((s, int(deg[s]), deg[nbrs[:4]].tolist(), p[:4],
                        list(zip(idx[:4].tolist(), vals[:4].tolist()))))
    kept = np.concatenate(kept)
    faults = "".join(f"\n  source {s} (degree {d}, first neighbours' degrees {nd}): file {p}, "
                     f"computed {c}" for s, d, nd, p, c in bad[:5])
    say(f"flagship rows: {len(kept):,} scores kept, the smallest {kept.min():.3e}; "
        f"{int((kept < 5e-7).sum())} print as 0.000000; sources with no node at an even step "
        f"(no edge, or an isolated star) {stars}; rows at fault {len(bad)}" + faults)
    check(not bad, "flagship: a row differs from the computed top-k, is empty where a walk "
          "reaches another node at an even step (or not empty where none does), or holds an "
          "invalid neighbour or a score not above 0" + faults)
    tiles = first["tile_s"] + second["tile_s"]
    hops_tile = FLAGSHIP["tile"] * (FLAGSHIP["sample"] // FLAGSHIP["times"]) * (2 * 5 + 3)
    rec = dict(card=card, generate_s=first["generate_s"], load_first_s=first["load_s"],
               load_cached_s=second["load_s"], tile_s=tiles, slots=first["slots"],
               hops_per_tile=hops_tile, g_hops_per_s=hops_tile * len(tiles) / sum(tiles) / 1e9,
               peak_gb=max(first["peak_gb"] or 0.0, second["peak_gb"] or 0.0), windows=3, sources=n)
    report["flagship"] = rec
    say(f"flagship V={v:,} ({rec['slots']:,} slots; {card}): generate {rec['generate_s']:.1f} s, "
        f"load {rec['load_first_s']:.1f} s (parse and CSR), cached {rec['load_cached_s']:.2f} s; "
        f"{len(tiles)} tiles of {FLAGSHIP['tile']:,} sources x {FLAGSHIP['sample'] // FLAGSHIP['times']:,} walks x 13 hops: s per tile "
        + ", ".join(f"{t:.3f}" for t in tiles) + f"; {rec['g_hops_per_s']:.3f} G hops/s; peak "
        f"{rec['peak_gb']:.2f} GB; 2 windows, stopped, resumed for the third: {n:,} sources "
        "once each")


FLAGSHIP_SGNS = dict(walks=65_536, hops=20, steps=10, batch=8192, sample=8192, key=23)
TOL_SGNS_10M = 1e-5      # sampled rows of the (1, 4) run vs the same steps on one card
PRECISION_ITERATIONS = 5
# "default" (TF32) against "highest" (fp32) after k iterations of
# S' = c·W·(S·Wᵀ), W row-stochastic, 0 <= S <= 1.  TF32 keeps 10 of fp32's
# 23 stored bits: an operand rounded to nearest is off by at most 2^-11 of
# itself.  A product of two rounded operands whose row weights sum to 1
# and whose entries are at most 1 is then off by at most 2·2^-11 (plus the
# error it inherits, not amplified: the weights sum to 1); an iteration has
# two products and is scaled by c < 1, so e_k <= c·(e_{k-1} + 4·2^-11) and
# e_k <= 4·2^-11·c/(1 - c) = 6·2^-11 at c = 0.6, under the 2·k·2^-11 held
# here (10·2^-11 at k = 5), which leaves room for fp32's own rounding in
# both modes' sums.
TOL_TF32_SIMRANK = 2 * PRECISION_ITERATIONS * 2.0 ** -11
SGNS_10M_COLS = ("table_bytes", "peak_gb", "step_ms", "first_step_ms", "lookup_ms", "compute_ms",
                 "update_ms", "wire_bytes_per_step", "rows")


def _flagship_sgns_rank(device, tmp, v):
    """Phase 19's SGNS on one rank of a (1, 4) mesh: its row shards drawn as
    ``train_sgns`` draws a mesh's (syn0's init, and syn1 from a second key
    in place of gensim's zeros so the first step moves syn0 too), then the
    saved batches through ``make_sgns_train_step``; writes its rows of the
    sampled ids and returns (rank 0) every rank's numbers."""
    import torch.distributed as dist

    from graphtpu_torch.core.config import SGNSConfig
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.dist import mesh as dm
    from graphtpu_torch.dist.sgns_dp import make_sgns_train_step, row_shards
    from graphtpu_torch.models.sgns import init_syn0

    mesh = dm.make_mesh(model_parallel=dist.get_world_size(), device=device)
    dev = mesh.device
    cfg = SGNSConfig()
    sh = row_shards(mesh, v)
    torch.cuda.reset_peak_memory_stats()
    _, shard_batch, train_step = make_sgns_train_step(mesh, cfg, v)
    params = tuple(init_syn0(key_for(FLAGSHIP_SGNS["key"], t), sh.lo, sh.rows, v, cfg.dim, dev)
                   for t in (0, 1))
    table_bytes = sum(p.numel() * p.element_size() for p in params)
    batches = torch.load(os.path.join(tmp, "batches.pt"))
    st, step_ms = {}, []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = train_step(params, *shard_batch(*b[:4]), b[4].item(), stage_times=st)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    ids = torch.from_numpy(np.load(os.path.join(tmp, "sample_ids.npy"))).to(dev)
    own = (ids >= sh.lo) & (ids < sh.lo + sh.rows)
    np.savez(os.path.join(tmp, f"rows_{mesh.rank}.npz"), ids=ids[own].cpu().numpy(),
             syn0=params[0][ids[own] - sh.lo].cpu().numpy(),
             syn1=params[1][ids[own] - sh.lo].cpu().numpy())
    k = len(batches)
    row = [table_bytes, peak, float(np.mean(step_ms[1:])), step_ms[0], st["lookup"] / k,
           st["compute"] / k, st["update"] / k, (st["lookup_bytes"] + st["update_bytes"]) / k,
           sh.rows]
    return dm.all_gather(torch.tensor(row, dtype=torch.float64, device=dev),
                         mesh.groups["model"]).cpu().numpy()


def phase_flagship_sgns(dev, tmp, report):
    """SGNS's model axis at the 10M flagship graph: 10 steps of
    ``make_sgns_train_step`` on a (1, 4) gloo mesh sharing the card (each
    rank 1/4 of each table), on batches drawn from uniform walks on the
    graph phase 19 built, against the same steps of ``sgns_step`` on whole
    tables on the card, on a seeded sample of touched and untouched rows."""
    from graphtpu_torch.core.config import SGNSConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.core.graph import load_graph_cached
    from graphtpu_torch.core.prng import generator, key_for
    from graphtpu_torch.dist.mesh import spawn
    from graphtpu_torch.models.sgns import _gather_batch, corpus_counts, init_syn0, sgns_step
    from graphtpu_torch.walks.walker import uniform_walks

    card = card_line()
    v, fs, cfg = FLAGSHIP["v"], FLAGSHIP_SGNS, SGNSConfig()
    t0 = time.perf_counter()
    g = load_graph_cached(os.path.join(tmp, "g.txt"), n_nodes=v).to(dev)
    gen = generator(key_for(fs["key"], 2), dev)
    starts = torch.randint(0, v, (fs["walks"],), generator=gen, device=dev, dtype=torch.int32)
    walks = uniform_walks(g, starts, fs["hops"], key_for(fs["key"], 3), device=dev)
    del g
    # the unigram^0.75 law of the walks for the shared negatives (the
    # trainer's alias table is a host loop over V; multinomial draws the law)
    law = corpus_counts(walks, v).double().pow(cfg.ns_exponent)
    batches, touched = [], torch.zeros(v, dtype=torch.bool, device=dev)
    for i in range(fs["steps"]):
        slots = torch.randint(0, walks.numel(), (fs["batch"],), generator=gen, device=dev)
        centers, contexts, mask = _gather_batch(walks, slots, cfg.window, gen)
        negs = torch.multinomial(law, fs["batch"] * cfg.negative, replacement=True,
                                 generator=gen).view(fs["batch"], cfg.negative).int()
        lr = cfg.alpha - (cfg.alpha - cfg.min_alpha) * i / fs["steps"]
        batches.append((centers, contexts, mask, negs, torch.tensor(lr)))
        for x in (centers[centers >= 0], contexts[mask], negs.reshape(-1)):
            touched[x.long()] = True
    torch.save([tuple(t.cpu() for t in b) for b in batches], os.path.join(tmp, "batches.pt"))
    rng = np.random.default_rng(fs["key"])
    hit = torch.nonzero(touched).view(-1).cpu().numpy()
    miss = torch.nonzero(~touched).view(-1).cpu().numpy()
    ids = np.sort(np.concatenate([rng.choice(hit, fs["sample"], replace=False),
                                  rng.choice(miss, fs["sample"], replace=False)]))
    np.save(os.path.join(tmp, "sample_ids.npy"), ids)
    prep_s = time.perf_counter() - t0
    del walks, law, touched
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    per = spawn(_flagship_sgns_rank, DIST_RANKS, "gloo", "cuda", args=(tmp, v), timeout=600)
    spawn_s = time.perf_counter() - t0
    got = {k: np.zeros((len(ids), cfg.dim), np.float32) for k in ("syn0", "syn1")}
    seen = np.zeros(len(ids), bool)
    for r in range(DIST_RANKS):
        with np.load(os.path.join(tmp, f"rows_{r}.npz")) as z:
            at = np.searchsorted(ids, z["ids"])
            seen[at] = True
            for k in got:
                got[k][at] = z[k]
    check(bool(seen.all()), "10M SGNS: a sampled row is on no rank")

    # the same steps on whole tables on one card
    params = tuple(init_syn0(key_for(fs["key"], t), 0, v, v, cfg.dim, dev) for t in (0, 1))
    init = tuple(p[torch.from_numpy(ids).to(dev)].cpu().numpy() for p in params)
    t0 = time.perf_counter()
    with full_fp32():
        for centers, contexts, mask, negs, lr in batches:
            params = sgns_step(params, centers, contexts, mask, negs, lr.item(), v)
    torch.cuda.synchronize()
    one_card_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    want = tuple(p[torch.from_numpy(ids).to(dev)].cpu().numpy() for p in params)
    del params, batches
    torch.cuda.empty_cache()
    err = max(float(np.abs(got[k] - w).max()) for k, w in zip(("syn0", "syn1"), want))
    untouched = np.isin(ids, miss)
    still = all(np.array_equal(got[k][untouched], i[untouched]) for k, i in zip(got, init))
    # a touched row moves in syn0 (a center's) or syn1 (a context's or a
    # negative's) unless its every pair was masked
    moved = float(((got["syn0"] != init[0]) | (got["syn1"] != init[1])).any(axis=1)
                  [~untouched].mean())
    whole_gb = v * cfg.dim * 4 / 1e9
    rec = {c: per[:, k].tolist() for k, c in enumerate(SGNS_10M_COLS)}
    rec.update(card=card, v=v, mesh=[1, DIST_RANKS], steps=fs["steps"], batch=fs["batch"],
               walks=[fs["walks"], fs["hops"]], prep_s=prep_s, spawn_s=spawn_s,
               one_card_step_ms=one_card_ms, max_abs_err=err, whole_table_gb=whole_gb)
    report["flagship_sgns"] = rec
    say(f"10M SGNS on a (1, {DIST_RANKS}) mesh ({card}): V = {v:,}, D = {cfg.dim}, "
        f"{fs['steps']} steps of B = {fs['batch']:,} (shared negatives) on {fs['walks']:,} walks "
        f"x {fs['hops']} hops; tables per rank " + ", ".join(f"{x / 1e9:.3f}" for x in per[:, 0])
        + f" GB (a whole table {whole_gb:.2f} GB); peak per rank "
        + ", ".join(f"{x:.3f}" for x in per[:, 1]) + " GB; ms per step (ranks' mean) "
        f"{per[:, 2].mean():.1f} (the first {per[:, 3].mean():.1f}): lookup "
        f"{per[:, 4].mean():.1f}, compute {per[:, 5].mean():.1f}, update {per[:, 6].mean():.1f} "
        f"(synchronised stages); into the all-reduces {per[0, 7] / 1e6:.1f} MB a step per rank; "
        f"one card on whole tables {one_card_ms:.1f} ms a step; {fs['sample']:,} touched and "
        f"{fs['sample']:,} untouched rows vs one card {err:.2e} (bound {TOL_SGNS_10M:g}); "
        f"batches drawn in {prep_s:.1f} s, spawn to end {spawn_s:.1f} s")
    check(bool((per[:, 0] == 2 * per[:, 8] * cfg.dim * 4).all()),
          "10M SGNS: a rank's tables are not its two shards")
    check(bool((per[:, 1] < whole_gb).all()), "10M SGNS: a rank's peak reached a whole table")
    check(err <= TOL_SGNS_10M, f"10M SGNS: sampled rows vs one card {err}")
    check(still and moved > 0.5,
          f"10M SGNS: untouched rows moved, or only {moved:.3f} of the touched ones did")


def phase_precision(dev, report):
    """``exact_simrank`` at blog, 5 iterations, at matmul_precision
    "highest", "high" and "default": "high" runs full float32 and must be
    "highest"'s bits; "default" allows TF32 and must differ from it, by at
    most TOL_TF32_SIMRANK; each mode's time and default's top-20 agreement."""
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.simrank.exact import exact_simrank

    card = card_line()
    g = blog_shaped_graph()
    cfg = SimRankConfig(iterations=PRECISION_ITERATIONS)
    modes = ("highest", "high", "default")
    runs = {m: [] for m in modes}
    sims = {}
    for _ in range(3):  # in turns, the first round a warm-up
        for m in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sims[m] = exact_simrank(g, cfg, matmul_precision=m, device=dev)
            torch.cuda.synchronize()
            runs[m].append(1e3 * (time.perf_counter() - t0))
    same = torch.equal(sims["high"], sims["highest"])
    err = float((sims["default"] - sims["highest"]).abs().max())
    k = 20
    top_hi = torch.topk(sims["highest"], k, dim=1).indices
    top_tf = torch.topk(sims["default"], k, dim=1).indices
    agree = float((top_tf[:, :, None] == top_hi[:, None, :]).any(-1).float().mean())
    ms = {m: float(np.median(runs[m][1:])) for m in modes}
    report["precision"] = dict(card=card, v=int(g.n_nodes), iterations=cfg.iterations, ms=ms,
                               high_equals_highest=same, default_max_abs_err=err,
                               bound=TOL_TF32_SIMRANK, default_top20_agreement=agree)
    say(f"dense precision, exact_simrank at blog (V = {g.n_nodes:,}, {cfg.iterations} "
        f"iterations; {card}): ms per call (median of 2, in turns) highest {ms['highest']:.2f}, "
        f"high {ms['high']:.2f}, default (TF32) {ms['default']:.2f}; high bit-equal to highest: "
        f"{same}; default vs highest {err:.3e} (bound {TOL_TF32_SIMRANK:.3e}), top-20 "
        f"agreement {agree:.4f}")
    check(same, "matmul_precision='high' differs from 'highest'")
    check(0.0 < err <= TOL_TF32_SIMRANK,
          f"matmul_precision='default' vs 'highest' {err}: TF32 off, or past its bound")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write a JSON report here")
    args = ap.parse_args(argv)
    report = {}

    say("== phase 1: device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    report["card"] = card

    say("== phase 2: build")
    from graphtpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    say(f"built {_build.library_path().name} from {_build.CSRC} in {build_s:.1f} s; "
        f"ptxas: {regs}")
    report["build_s"] = build_s
    from graphtpu_torch import native

    t0 = time.perf_counter()
    native.load()
    report["native_build_s"] = time.perf_counter() - t0
    say(f"built {native.library_path().name} (g++, the C++ parser and generator) in "
        f"{report['native_build_s']:.1f} s")

    say("== phase 3: kernels B1, B2 against their plain version")
    cases, blog_items = phase_kernels(dev, report)
    large = phase_kernels_large(dev, report)

    say("== phase 4: kernel B3 against its plain version")
    tree_cases = phase_tree_kernel(dev, report)

    from graphtpu_torch.io.edgelist import write_edgelist

    with tempfile.TemporaryDirectory() as tmp:
        say("== phase 5: main path (blog-shaped graph)")
        path = os.path.join(tmp, "blog.txt")
        write_edgelist(path, blog_shaped_edges())
        launches = run_main_path(dev, path, BLOG_NODES, ["kahan", "fast", "fast16"],
                                 report, "blog", "panel")

        say("== phase 6: skewed degrees (R-MAT)")
        path = os.path.join(tmp, "rmat.txt")
        write_edgelist(path, rmat14_edges())
        more = run_main_path(dev, path, RMAT14_NODES, ["kahan"], report, "rmat", "packed",
                             row_tiles_check=True)

        say("== phase 6b: the arxiv shape (V = 38,912)")
        path = os.path.join(tmp, "arxiv.txt")
        write_edgelist(path, arxiv_shaped_edges())
        arxiv = run_arxiv_path(dev, path, report)
    for k in launches:
        launches[k] += more[k] + arxiv[k]
        check(launches[k] > 0, f"kernel {k} was never launched on the main path")

    say("== phase 7: tree path (exact_simrank_spmm impl='tree')")
    launches["gather"] = run_tree_path(dev, blog_shaped_graph(), "blog",
                                       [torch.float32, torch.bfloat16], report)
    rmat_tree_launches = run_tree_path(dev, rmat14_graph(), "rmat", [torch.float32], report)
    launches["gather"] += rmat_tree_launches

    say("== phase 8: SpMV item-rate probe")
    rate_launches, rate_cases = phase_rate_probe(dev, report)
    launches.update(rate_launches)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was never launched on its path")

    say("== phase 9: walks (blog-shaped graph; V = 60,000 for the cuckoo edge set)")
    blog_g, corpus = phase_walks(dev, report)

    say("== phase 10: SGNS on the blog walks")
    phase_sgns(dev, blog_g, corpus, report)
    del blog_g, corpus
    torch.cuda.empty_cache()

    say("== phase 11: python -m graphtpu_torch node2vec")
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp, report)

    say("== phase 12: Monte-Carlo SimRank engines (UniWalk, TopSim, reuse windows)")
    phase_mc(dev, report)
    torch.cuda.empty_cache()

    say("== phase 13: python -m graphtpu_torch uniwalk, topsim and sweep")
    with tempfile.TemporaryDirectory() as tmp:
        phase_mc_cli(tmp, report)

    with tempfile.TemporaryDirectory() as tmp:
        say("== phase 14: DeepSim (simrank --engine spmm, then deepsim)")
        blog_sims = phase_deepsim(dev, tmp, report)
        torch.cuda.empty_cache()
        say("== phase 15: SDNE")
        phase_sdne(dev, tmp, report)
        torch.cuda.empty_cache()
        say("== phase 16: Laplacian Eigenmaps")
        phase_le(dev, tmp, blog_sims, report)
        torch.cuda.empty_cache()
        say("== phase 17: BFS, weight statistics, the C++ parser and generator, the CSR cache")
        phase_support(dev, tmp, report)

    say(f"== phase 18: dist ({DIST_RANKS} gloo ranks on the card, then 1 NCCL rank; blog-shaped)")
    dist_launches, dist_b3_err = phase_dist(dev, report)
    launches["gather"] += dist_launches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        say("== phase 19: the 10M flagship (generate, load, 2 windows, stop, resume the third; "
            f"then SGNS on a (1, {DIST_RANKS}) mesh)")
        phase_flagship(dev, tmp, report)
        torch.cuda.empty_cache()
        phase_flagship_sgns(dev, tmp, report)
    torch.cuda.empty_cache()

    say("== phase 20: dense precision (exact_simrank at highest, high and default)")
    phase_precision(dev, report)

    from graphtpu_torch.bench import bounds
    from graphtpu_torch.bench.spmv_rate import N_BUF

    def entry(name, source, replaces, key, errs, timed, work, library):
        bound_ms, bound_by = bounds.bound(*work)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[key], max_abs_err=max(errs), ms=timed["ms"],
                    plain_ms=timed["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library)

    summary = []
    for kernel, label, pick, lib in (("kahan", "spmv_kahan_f32 (B1)", "kahan_f32_pin", "kahan_f32"),
                                     ("fast", "spmv_fast (B2)", "fast_f32_pin", "fast_f32")):
        mine = [c for c in cases if c["kernel"] == kernel and c["dtype"] == "float32"]
        timed = next(c for c in cases if c["case"] == pick)
        work = bounds.spmv_work(blog_items, 1, BLOG_NODES, BLOG_NODES, 4, kernel, pin=True,
                                multiply=kernel == "kahan")
        x = entry(label, SOURCE, REPLACES[kernel], kernel,
                  [c["max_abs_err_plain"] for c in mine + large
                   if c["kernel"] == kernel and c["dtype"] == "float32"], timed, work,
                  next(c for c in cases if c["case"] == lib)["library_ms"])
        # C = V on R-MAT 14 and the arxiv shape: the pinned f32 product in the
        # stream's design beside the row tiles, and the unpinned library call
        x["shapes"] = {
            tag: {k: next(c for c in large if c["case"] == f"{tag}_{pick}")[k]
                  for k in ("design", "ms", "row_tiles_ms", "plain_ms", "bound_ms", "bound_by")}
            | {"library_ms": next(c for c in large if c["case"] == f"{tag}_{lib}")["library_ms"]}
            for tag in ("rmat", "arxiv")}
        summary.append(x)
    level0, level1 = tree_cases[0], tree_cases[1]  # the largest level, first column block
    t0 = report["tree_level0"]
    b3 = entry(
        "gather_rows_sum (B3)", "graphtpu_torch/kernels/csrc/gather.cu",
        "graphtpu/kernels/spmm.py:851", "gather",
        [c["max_abs_err_plain"] for c in tree_cases] + [dist_b3_err],
        level0, bounds.gather_work(t0["real_rows"], t0["width"], t0["c"], t0["table_rows"], 4),
        level0["library_ms"])
    # `ms` is level 0 alone, whose panel stores slab-major; level 1 pays for
    # reading the slabs, so levels 0 + 1 and the whole product are given
    # beside it, each against the row tiles alone
    t1, prod = level1["ms_by_design"], report["tree_product"]["ms_by_dtype"]["f32"]
    b3.update(levels01_ms=level0["ms"] + level1["ms"],
              levels01_row_tiles_ms=level0["ms_by_design"]["rows"] + t1["rows"],
              product_ms=prod["panel"], product_row_tiles_ms=prod["rows"])
    # R-MAT 14's tree, whose levels all run row tiles: each level's time and
    # bound in the first column block, the embedding_bag of level 0, and the
    # launches of its tree path (phase 7)
    rmat_levels = [c for c in tree_cases if c["case"].startswith("rmat_level")]
    b3["rmat"] = dict(
        design=rmat_levels[0]["design"], launches=rmat_tree_launches,
        levels_ms=[c["ms"] for c in rmat_levels], plain_ms=[c["plain_ms"] for c in rmat_levels],
        bound_ms=[c["bound_ms"] for c in rmat_levels],
        bound_by=[c["bound_by"] for c in rmat_levels], library_ms=rmat_levels[0]["library_ms"])
    summary.append(b3)
    for key, label, replaces in RATE_KERNELS:
        mine = [c for c in rate_cases if c["kernel"] == key]
        timed = next(c for c in mine if c["graph"] == "blog")
        work = bounds.rate_work(key, timed["items"], timed["v"], timed["v"], N_BUF)
        x = entry(label, RATE_SOURCE, replaces, key, [c["max_abs_err_plain"] for c in mine],
                  timed, work, timed["library_ms"])
        x.update(design=timed["design"], ms_by_design=timed["ms_by_design"])
        summary.append(x)
    report["kernels"] = summary
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    paths = {k: report[k] for k in ("walks", "sgns", "cli")}
    paths["mc"] = dict(report["mc"], cli=report["mc_cli"])
    paths.update({k: report[k] for k in ("deepsim", "sdne", "le", "support", "dist", "flagship",
                                         "flagship_sgns", "precision")})
    print(json.dumps({"paths": paths}))
    say(card_line())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
