#!/usr/bin/env python3
"""Drive graphtpu_torch's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py [--out report.json]

Phases (any failure raises and the run exits non-zero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the hand kernels from graphtpu_torch/kernels/csrc.
  3. kernels: kernels B1 (Kahan) and B2 (fast) against their plain PyTorch
     version and the float64 oracle on the blog-shaped stream (V = C =
     10,496, the column-panel design), plus seg-2 (row tiles), ragged and
     bf16 cases, a V = 60,000 case (row tiles) and the Kahan hub at degree
     20,000 (row tiles) and 11,000 (the panel): B1, and B2 in the panel,
     within 1e-5, while a sequential f32 sum must miss; every case launched
     twice and the outputs held bit-equal; CUDA-event times of kernel,
     plain version and one torch.sparse.mm.
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
  6. skew: the kahan run again on an R-MAT graph (V = 16,384, row tiles).
  7. tree path: ``exact_simrank_spmm(impl="tree")`` on the blog-shaped
     graph (f32, bf16) and R-MAT (f32); B3 launch counts, scores against
     the dense fp32 engine, per-stage times, the compact plans' host ms and
     peak memory.
  8. rate probe: ``python -m graphtpu_torch.bench.spmv_rate`` on both
     graphs (ns per item of B1, B2, X1-X3; X1-X3 on B2's panel at blog,
     each beside B2, and B2 - X2 as the panel's share), then X1-X3 against
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
The new phases' numbers are printed as a ``{"paths": ...}`` line.
The last two lines are the kernels' JSON summary (with each kernel's bound
from graphtpu_torch/bench/bounds.py; B3's level-0 time excludes the cost its
slab-major output moves to level 1, so its entry also gives levels 0 + 1
and the whole product, each against the row tiles alone) and the JSON
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from graphtpu_torch.bench.generators import (
    BLOG_NODES,
    RMAT14_NODES,
    blog_shaped_edges,
    blog_shaped_graph,
    rmat14_edges,
    rmat14_graph,
)
from graphtpu_torch.bench.timing import busy_ms, cuda_ms

TOL_F32 = 1e-5        # f32 product vs plain version / float64 oracle, values <= 1
TOL_B3 = 1e-6         # B3 vs its plain version (same operations: bit-equal expected)
TOL_RATE = 1e-5       # X2/X3 vs plain, relative to the row's sum of |terms|
TOL_SIM_F32 = 2e-5    # SimRank scores, f32 modes, vs the dense fp32 engine
TOL_SIM_BF16 = 1e-2   # SimRank scores, fast16, vs the dense fp32 engine
C_RAGGED = 10_313
HUB_DEGREES = (20_000, 11_000)  # row tiles; the column panel (V <= 11,448)
V_PANELS, C_PANELS = 60_000, 256  # a V past one block's shared memory
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


def csr_of(plan, v, weights):
    """The stream's P as a [V, V] CSR (rows < V), for the library yardstick."""
    pos, slots = plan.pos.long(), plan.slots.long()
    keep = pos < v
    w = weights.view(-1)[: pos.numel()][keep]
    crow = torch.searchsorted(pos[keep], torch.arange(v + 1, device=pos.device))
    return torch.sparse_csr_tensor(crow, slots[keep], w, (v, v))


def library_ms(fn):
    """CUDA-event time of one PyTorch call, or None where it does not run."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        say(f"  library call not available: {str(e).splitlines()[0][:120]}")
        return None
    return cuda_ms(fn)


def v60000_graph():
    """V = 60,000 (past one block's shared memory): 200,000 random edges
    and a hub of degree 3,000 at node 7."""
    from graphtpu_torch import build_graph

    rng = np.random.default_rng(4)
    edges = rng.integers(0, V_PANELS, size=(200_000, 2))
    hub = np.stack([np.full(3000, 7), rng.choice(V_PANELS, 3000, replace=False)], 1)
    return build_graph(np.concatenate([edges[edges[:, 0] != edges[:, 1]], hub]),
                       n_nodes=V_PANELS)


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
        used = "panel" if p.sell is not None else "rows"
        ms = cuda_ms(lambda: spmm.spmv(p, table, mode, ts))
        plain_ms = cuda_ms(lambda: spmm.spmv_plain(p, table, mode, ts), warmup=1, runs=5)
        lib_ms = None
        if ts is None and p is plan and name in ("kahan_f32", "fast_f32", "fast_bf16"):
            # one PyTorch call of the same product: the folded P as CSR
            csr = csr_of(p, gg.n_nodes, p.wts).to(table.dtype)
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
        design = "panel" if hub_plan.sell is not None else "rows"
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
        if name == "level0_strided":
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


def run_main_path(dev, path, n_nodes, modes, report, tag):
    """CLI runs over one edge file; returns each kernel's launches."""
    from graphtpu_torch import read_edgelist_graph
    from graphtpu_torch.cli import main as cli_main
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.io.simfile import read_sim_file, read_topk_ids
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

        sims = read_sim_file(out + ".sim.txt")
        ids[mode] = read_topk_ids(out)
        top[mode] = np.array([sims[r][0][1] for r in range(n_nodes)])
        check(sorted(sims) == list(range(n_nodes)), f"{tag} {mode}: rows in file")
        scores = np.array([[s for _, s in sims[r]] for r in range(n_nodes)])
        check(scores.shape == (n_nodes, 20) and np.isfinite(scores).all(),
              f"{tag} {mode}: file scores shape {scores.shape}")
        tol = TOL_SIM_BF16 if mode == "fast16" else TOL_SIM_F32
        file_err = float(np.abs(scores - dense_top).max())
        check(file_err <= tol + 5e-7, f"{tag} {mode}: file top-20 scores vs dense {file_err}")

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
        del sim
        per_iter = {k: stages[k] / cfg.iterations
                    for k in ("product1", "transpose", "product2")}
        row = dict(graph=tag, mode=mode, V=n_nodes, slots=g.n_edges,
                   max_degree=g.max_degree, launches=rise, max_abs_err_dense=err,
                   bound=tol, file_topk_err=file_err, cli_wall_s=cli_s,
                   spmm_call_wall_s=call_s, stage_ms_per_iter=per_iter,
                   layout_host_ms=stages["layout_host"], peak_gb=peak_gb)
        out_rows.append(row)
        say(f"{tag} {mode}: launches {rise}; S vs dense fp32 max err {err:.3e} "
            f"(bound {tol:g}); file top-20 vs dense {file_err:.3e}; per iteration "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in per_iter.items())
            + f" (CUDA events); sliced layout {stages['layout_host']:.1f} ms (host); "
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
    ones = csr_of(stream, stream.n_nodes, torch.ones_like(stream.wts))
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

    cases = []
    for tag in ("blog", "rmat"):
        g = spmv_rate.GRAPHS[tag]()
        stream = spmm.build_spmv_stream(g, device=dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        table = torch.rand((g.n_nodes, g.n_nodes), generator=gen, device=dev)
        buf = torch.rand((spmv_rate.N_BUF, g.n_nodes), generator=gen, device=dev)
        rows_st = dataclasses.replace(stream, sell=None)
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

    say("== phase 3: kernels B1, B2 against their plain version")
    cases, blog_items = phase_kernels(dev, report)

    say("== phase 4: kernel B3 against its plain version")
    tree_cases = phase_tree_kernel(dev, report)

    from graphtpu_torch.io.edgelist import write_edgelist

    with tempfile.TemporaryDirectory() as tmp:
        say("== phase 5: main path (blog-shaped graph)")
        path = os.path.join(tmp, "blog.txt")
        write_edgelist(path, blog_shaped_edges())
        launches = run_main_path(dev, path, BLOG_NODES, ["kahan", "fast", "fast16"],
                                 report, "blog")

        say("== phase 6: skewed degrees (R-MAT)")
        path = os.path.join(tmp, "rmat.txt")
        write_edgelist(path, rmat14_edges())
        more = run_main_path(dev, path, RMAT14_NODES, ["kahan"], report, "rmat")
    for k in launches:
        launches[k] += more[k]
        check(launches[k] > 0, f"kernel {k} was never launched on the main path")

    say("== phase 7: tree path (exact_simrank_spmm impl='tree')")
    launches["gather"] = run_tree_path(dev, blog_shaped_graph(), "blog",
                                       [torch.float32, torch.bfloat16], report)
    launches["gather"] += run_tree_path(dev, rmat14_graph(), "rmat", [torch.float32], report)

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
        summary.append(entry(label, SOURCE, REPLACES[kernel], kernel,
                             [c["max_abs_err_plain"] for c in mine], timed, work,
                             next(c for c in cases if c["case"] == lib)["library_ms"]))
    level0, level1 = tree_cases[0], tree_cases[1]  # the largest level, first column block
    t0 = report["tree_level0"]
    b3 = entry(
        "gather_rows_sum (B3)", "graphtpu_torch/kernels/csrc/gather.cu",
        "graphtpu/kernels/spmm.py:851", "gather", [c["max_abs_err_plain"] for c in tree_cases],
        level0, bounds.gather_work(t0["real_rows"], t0["width"], t0["c"], t0["table_rows"], 4),
        level0["library_ms"])
    # `ms` is level 0 alone, whose panel stores slab-major; level 1 pays for
    # reading the slabs, so levels 0 + 1 and the whole product are given
    # beside it, each against the row tiles alone
    t1, prod = level1["ms_by_design"], report["tree_product"]["ms_by_dtype"]["f32"]
    b3.update(levels01_ms=level0["ms"] + level1["ms"],
              levels01_row_tiles_ms=level0["ms_by_design"]["rows"] + t1["rows"],
              product_ms=prod["panel"], product_row_tiles_ms=prod["rows"])
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
    print(json.dumps({"paths": {k: report[k] for k in ("walks", "sgns", "cli")}}))
    say(card_line())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
