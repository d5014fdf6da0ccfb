"""Kernels B1/B2 against an earlier build of themselves, in turns, on one card.

    python -m graphtpu_torch.bench.spmv_ab --old-csrc DIR [--out ab.json]

``DIR`` holds an earlier ``graphtpu_torch/kernels/csrc`` whose ``spmv.cu``
has today's entry points (``gt_spmv_kahan_f32(slots, wts, row_items, sell,
table, out, v, c, seg_k, pin, scale, stream)`` and ``gt_spmv_fast(slots,
raw_wts, scales, row_items, sell, table, out, v, c, seg_k, pin, scale, mul,
bf16, stream)``, commit 4fb4c8d or later: a ``struct GtSell`` that is a
prefix of today's), for example a ``git archive`` of an earlier commit
unpacked into a git-ignored directory.  The script builds it with nvcc
and, at the shapes the main path gives the kernels (blog-shaped V = C =
10,496 and R-MAT V = C = 16,384, seed 0; f32 and bf16 tables, with and
without the fused pin), and on the blog-shaped graph's other streams
(seg-2 after an RCM relabel, as ``--relabel rcm --seg 2`` runs it, and
random edge weights), runs both builds in the design the stream gives
them (the column panel over its sliced layout, or row tiles), times old,
new, new, old with CUDA events (the median of 9 launches each) and counts
the elements where the new output differs from the old one (expected 0:
the same operations in the same order).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from graphtpu_torch.bench.generators import (
    BLOG_NODES,
    blog_shaped_edges,
    blog_shaped_graph,
    rmat14_graph,
)
from graphtpu_torch.bench.timing import cuda_ms
from graphtpu_torch.kernels import _build, spmm

CASES = (  # stream, mode, dtype, table_scale
    ("blog", "kahan", torch.float32, 0.6),
    ("blog", "fast", torch.float32, 0.6),
    ("blog", "fast", torch.bfloat16, 0.6),
    ("blog", "kahan", torch.float32, None),
    ("blog", "fast", torch.float32, None),
    ("blog_seg2_rcm", "kahan", torch.float32, 0.6),
    ("blog_seg2_rcm", "fast", torch.float32, 0.6),
    ("blog_weighted", "kahan", torch.float32, 0.6),
    ("blog_weighted", "fast", torch.float32, 0.6),
    ("rmat", "kahan", torch.float32, 0.6),
    ("rmat", "fast", torch.float32, 0.6),
)


def build_old(csrc: str, out_dir: str) -> ctypes.CDLL:
    """nvcc the earlier ``spmv.cu`` (with its headers) into a library."""
    lib = os.path.join(out_dir, "libspmv_old.so")
    _build.compile_library([os.path.join(csrc, "spmv.cu")], lib)
    old = ctypes.CDLL(lib)
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    old.gt_spmv_kahan_f32.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, f32, p]
    old.gt_spmv_fast.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, f32, i32, i32, p]
    return old


def old_spmv(old, stream, table, mode, table_scale):
    v, c = stream.n_nodes, table.shape[1]
    out = torch.empty((v + 1, c), dtype=table.dtype, device=table.device)
    pin = table_scale is not None
    scale = ctypes.c_float(float(table_scale) if pin else 0.0)
    cu = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sell = hub_acc = None  # held until the launch is enqueued
    if stream.sell is not None:
        sell, hub_acc = spmm.sell_launch_args(stream.sell, c, mode == "kahan", table.device)
    if mode == "kahan":
        rc = old.gt_spmv_kahan_f32(stream.slots.data_ptr(), stream.wts.data_ptr(),
                                   stream.row_items.data_ptr(), sell, table.data_ptr(),
                                   out.data_ptr(), v, c, stream.seg_k, int(pin), scale, cu)
    else:
        rc = old.gt_spmv_fast(stream.slots.data_ptr(), stream.raw_wts.data_ptr(),
                              stream.scales.data_ptr(), stream.row_items.data_ptr(), sell,
                              table.data_ptr(), out.data_ptr(), v, c, stream.seg_k,
                              int(pin), scale, int(not (stream.uniform and stream.seg_k == 1)),
                              int(table.dtype == torch.bfloat16), cu)
    if rc:
        raise RuntimeError(f"old spmv {mode} launch failed: {rc}")
    return out


def streams(dev):
    """(tag, stream) of each stream the cases run over."""
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.reorder import rcm_order, relabel_graph

    blog = blog_shaped_graph()
    yield "blog", spmm.build_spmv_stream(blog, device=dev)
    rcm, _ = relabel_graph(blog, rcm_order(blog))
    yield "blog_seg2_rcm", spmm.build_spmv_segments(rcm, k=2, device=dev)
    edges = blog_shaped_edges()
    wts = (np.random.default_rng(0).random(len(edges)) + 0.1).astype(np.float32)
    weighted = build_graph(edges, weights=wts, n_nodes=BLOG_NODES)
    yield "blog_weighted", spmm.build_spmv_stream(weighted, weighted=True, device=dev)
    yield "rmat", spmm.build_spmv_stream(rmat14_graph(), device=dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier kernel sources")
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("spmv_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(args.old_csrc, tmp)
        _build.load()
        rows = []
        for tag, stream in streams(dev):
            design = "panel" if stream.sell is not None else "rows"
            v = stream.n_nodes
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.rand((v, v), generator=gen, device=dev)
            for stag, mode, dtype, ts in CASES:
                if stag != tag:
                    continue
                table = x.to(dtype)
                new_out = spmm.spmv(stream, table, mode, ts)
                old_out = old_spmv(old, stream, table, mode, ts)
                torch.cuda.synchronize()
                diff = (new_out.float() - old_out.float()).abs()
                unequal = int((new_out != old_out).sum().item())
                t = [cuda_ms(lambda: old_spmv(old, stream, table, mode, ts)),
                     cuda_ms(lambda: spmm.spmv(stream, table, mode, ts)),
                     cuda_ms(lambda: spmm.spmv(stream, table, mode, ts)),
                     cuda_ms(lambda: old_spmv(old, stream, table, mode, ts))]
                r = dict(graph=tag, mode=mode, dtype=str(dtype).split(".")[-1],
                         pin=ts is not None, design=design, old_ms=[t[0], t[3]],
                         new_ms=[t[1], t[2]], max_abs_diff=diff.max().item(),
                         unequal=unequal)
                rows.append(r)
                print(f"{tag} {mode} {r['dtype']} pin={r['pin']} ({design}): old "
                      f"{t[0]:.3f}/{t[3]:.3f} ms, new {t[1]:.3f}/{t[2]:.3f} ms; "
                      f"max |new-old| {r['max_abs_diff']:.3e}, {unequal} unequal elements",
                      flush=True)
                del new_out, old_out, diff, table
            del x
            torch.cuda.empty_cache()
    res = dict(card=card, cases=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
