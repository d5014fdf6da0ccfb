"""Kernels B3 and X1-X3 against an earlier build of themselves, in turns, on one card.

    python -m graphtpu_torch.bench.tree_ab --old-csrc DIR [--out ab.json]

``DIR`` holds an earlier ``graphtpu_torch/kernels/csrc`` whose entry points
are ``gt_gather_rows_sum(slots, wts, table, ld, table_slabs, out, ldo, m, w,
c, bf16, plan, stream)``, ``gt_rate_unroll8(slots, row_items, sell, table,
out, n_rows_out, c, stream)`` and the row-tile
``gt_rate_gather_only``/``gt_rate_accumulate_only(first, row_items, x,
out, n_rows_out, c, stream)`` (commit d20a0d3), for example a ``git
archive`` of it unpacked into a git-ignored directory.  The script builds
its sources with nvcc and, at the shapes ``chip_smoke.py``'s phase 4 gives
B3 (every level of the blog-shaped and R-MAT trees at a 4,096-column
block, level 0 read in place from the [V, V] iterate; blog level 0 also as
the ragged tail block, at C = 10,313, over a bf16 table and in the
weighted tree) and at the probe's shapes (both streams at C = V), times
old, new, new, old with CUDA events (the median of 9 launches each), and,
where the new kernel runs the column panel, the new row tiles twice
between them.  A level with
a compact plan runs as tree_spmm runs it below the last level: the panel
storing slab-major, in both builds.  It counts the elements where the new
output differs from the old one, expected 0: B3, X1 and X3 everywhere, X2
on the rows the panel sums one lane a row (hub rows are summed
lane-strided there).  Seed 0.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from graphtpu_torch import build_graph
from graphtpu_torch.bench import spmv_rate
from graphtpu_torch.bench.generators import (
    BLOG_NODES,
    blog_shaped_edges,
    blog_shaped_graph,
    rmat14_graph,
)
from graphtpu_torch.bench.timing import cuda_ms
from graphtpu_torch.kernels import _build, spmm

COL_BLOCK = 4096
C_RAGGED = 10_313


def build_old(csrc: str, out_dir: str) -> ctypes.CDLL:
    """nvcc the earlier kernel sources into a library."""
    lib = os.path.join(out_dir, "libtree_old.so")
    _build.compile_library(sorted(glob.glob(os.path.join(csrc, "*.cu"))), lib)
    old = ctypes.CDLL(lib)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    old.gt_gather_rows_sum.argtypes = [p, p, p, i64, i32, p, i64, i64, i32, i64, i32, p, p]
    old.gt_rate_unroll8.argtypes = [p, p, p, p, p, i64, i64, p]
    old.gt_rate_gather_only.argtypes = [p, p, p, p, i64, i64, p]
    old.gt_rate_accumulate_only.argtypes = [p, p, p, p, i64, i64, p]
    return old


def _cu():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def old_gather(old, slots, wts, table, lay):
    """The earlier B3 as tree_spmm launches it: the panel storing slab-major
    where the level has a compact plan, row tiles otherwise."""
    m, w = slots.shape
    c = table.shape[1]
    plan = None
    if lay is None:
        out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    else:
        out = torch.empty((-(-c // 4), m, 4), dtype=torch.float32, device=table.device)
        plan = ctypes.byref(_build.GtGather(lay.data.data_ptr(), lay.n_chunks, lay.n_table))
    rc = old.gt_gather_rows_sum(slots.data_ptr(), wts.data_ptr(), table.data_ptr(),
                                table.stride(0), 0, out.data_ptr(),
                                c if lay is None else m, m, w, c,
                                int(table.dtype == torch.bfloat16), plan, _cu())
    if rc:
        raise RuntimeError(f"old gather launch failed: {rc}")
    return out


def old_rate(old, key, stream, x):
    """The earlier X kernel ``key``: X3 on the panel where the stream has a
    sliced layout (its struct is a prefix of today's), X1 and X2 row tiles."""
    v, c = stream.n_nodes, x.shape[1]
    out = torch.empty((v + 1, c), dtype=torch.float32, device=x.device)
    first = stream.wts if key == "accumulate_only" else stream.slots
    args = (first.data_ptr(), stream.row_items.data_ptr())
    hub_acc = None  # held until the launch is enqueued
    if key == "unroll8":
        sell = None
        if stream.sell is not None:
            sell, hub_acc = spmm.sell_launch_args(stream.sell, c, False, x.device)
        args += (sell,)
    rc = getattr(old, f"gt_rate_{key}")(*args, x.data_ptr(), out.data_ptr(), v + 1, c, _cu())
    if rc:
        raise RuntimeError(f"old {key} launch failed: {rc}")
    return out


def in_turns(old_fn, new_fn, rows_fn=None):
    """CUDA-event ms: old, new, (row tiles, row tiles,) new, old."""
    t = {"old_ms": [cuda_ms(old_fn)], "new_ms": [cuda_ms(new_fn)]}
    if rows_fn is not None:
        t["new_rows_ms"] = [cuda_ms(rows_fn), cuda_ms(rows_fn)]
    t["new_ms"].append(cuda_ms(new_fn))
    t["old_ms"].append(cuda_ms(old_fn))
    return t


def tree_cases(dev):
    """(name, slots, weights, layout, table) of each phase-4 level."""
    x = torch.rand((BLOG_NODES, BLOG_NODES), generator=torch.Generator(device=dev)
                   .manual_seed(0), device=dev)
    g = blog_shaped_graph()
    edges = blog_shaped_edges()
    wts = (np.random.default_rng(0).random(len(edges)) + 0.1).astype(np.float32)
    gw = build_graph(edges, weights=wts, n_nodes=BLOG_NODES)
    trees = {"blog": spmm.build_reduction_tree(g, device=dev),
             "blog_weighted": spmm.build_reduction_tree(gw, weighted=True, device=dev),
             "rmat": spmm.build_reduction_tree(rmat14_graph(), device=dev)}
    xr = torch.rand((trees["rmat"].n_nodes,) * 2, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    for tag, t, xx in (("blog", trees["blog"], x), ("rmat", trees["rmat"], xr)):
        cur = xx[:, :COL_BLOCK]
        for k in range(len(t.levels)):
            yield f"{tag}_level{k}", t.levels[k], t.weights[k], t.layout(k), cur
            cur = spmm.gather_rows_sum(t.levels[k], t.weights[k], cur)
        del cur
    t, tw = trees["blog"], trees["blog_weighted"]
    lv0 = (t.levels[0], t.weights[0], t.layout(0))
    yield "blog_level0_tail", *lv0, x[:, 2 * COL_BLOCK:]
    yield "blog_level0_C10313", *lv0, x[:, :C_RAGGED].contiguous()
    yield "blog_level0_bf16", *lv0, x.bfloat16()[:, :COL_BLOCK]
    yield "blog_weighted_level0", tw.levels[0], tw.weights[0], tw.layout(0), x[:, :COL_BLOCK]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier kernel sources")
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tree_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(args.old_csrc, tmp)
        _build.load()
        for name, sl, w, lay, table in tree_cases(dev):
            # the new build as tree_spmm runs a level below the last: the
            # panel storing slab-major where the level has a plan
            c = table.shape[1]
            new_fn = (lambda: spmm.gather_rows_sum(sl, w, table)) if lay is None else (
                lambda: spmm._gather_cuda(sl, w, table, None, lay))
            rows_fn = None if lay is None else (lambda: spmm.gather_rows_sum(sl, w, table))
            new_out, old_out = new_fn(), old_gather(old, sl, w, table, lay)
            unequal = int((new_out != old_out).sum().item())
            t = in_turns(lambda: old_gather(old, sl, w, table, lay), new_fn, rows_fn)
            r = dict(kernel="B3", case=name, rows=int(sl.shape[0]), width=int(table.shape[1]),
                     dtype=str(table.dtype).split(".")[-1],
                     design="rows" if lay is None else "panel",
                     unequal=unequal, **t)
            rows.append(r)
            print(f"B3 {name} ({r['design']}): old "
                  + "/".join(f"{x:.3f}" for x in t["old_ms"]) + " ms, new "
                  + "/".join(f"{x:.3f}" for x in t["new_ms"]) + " ms"
                  + ("" if lay is None else ", new row tiles "
                     + "/".join(f"{x:.3f}" for x in t["new_rows_ms"]) + " ms")
                  + f"; {unequal} unequal elements", flush=True)
            del new_out, old_out
        torch.cuda.empty_cache()
        for tag, make in spmv_rate.GRAPHS.items():
            stream = spmm.build_spmv_stream(make(seed=0), device=dev)
            v = stream.n_nodes
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.rand((v, v), generator=gen, device=dev)
            buf = torch.rand((spmv_rate.N_BUF, v), generator=gen, device=dev)
            rows_st = dataclasses.replace(stream, sell=None)
            lane = np.arange(v + 1)
            if stream.sell is not None:
                lane = np.setdiff1d(lane, stream.sell.hub_rows.cpu().numpy())
            lane = torch.as_tensor(lane, device=dev)
            for key, label in (("gather_only", "X1"), ("accumulate_only", "X2"),
                               ("unroll8", "X3")):
                arg = buf if key == "accumulate_only" else x
                fn = getattr(spmv_rate, key)
                design = spmv_rate.design(key, stream)
                new_out, old_out = fn(stream, arg), old_rate(old, key, stream, arg)
                # X2's old kernel is row tiles, whose hub-row sums the panel
                # does not repeat bit for bit
                on = lane if key == "accumulate_only" else slice(None)
                unequal = int((new_out[on] != old_out[on]).sum().item())
                diff = ((new_out - old_out).abs() / old_out.abs().clamp(min=1e-30)).max().item()
                t = in_turns(lambda: old_rate(old, key, stream, arg), lambda: fn(stream, arg),
                             None if design == "rows" else lambda: fn(rows_st, arg))
                r = dict(kernel=label, case=tag, rows=v + 1, width=v, dtype="float32",
                         design=design, unequal=unequal,
                         unequal_on="lane rows" if key == "accumulate_only" else "all",
                         max_rel_diff=diff, **t)
                rows.append(r)
                print(f"{label} {tag} ({design}): old " + "/".join(f"{x:.3f}" for x in t["old_ms"])
                      + " ms, new " + "/".join(f"{x:.3f}" for x in t["new_ms"]) + " ms"
                      + ("" if design == "rows" else ", new row tiles "
                         + "/".join(f"{x:.3f}" for x in t["new_rows_ms"]) + " ms")
                      + f"; {unequal} unequal elements ({r['unequal_on']}), max relative "
                      f"|new-old| {diff:.3e}", flush=True)
                del new_out, old_out
            del x, buf
            torch.cuda.empty_cache()
    res = dict(card=card, cases=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
