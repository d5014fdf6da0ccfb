"""Kernels B1/B2 against an earlier build of themselves, in turns, on one card.

    python -m graphtpu_torch.bench.spmv_ab --old-csrc DIR [--only TAGS] [--force]
        [--hot N,..] [--plain] [--out ab.json]

``DIR`` holds an earlier ``graphtpu_torch/kernels/csrc`` whose ``spmv.cu``
has today's entry points (``gt_spmv_kahan_f32(slots, wts, row_items, sell,
table, out, v, c, seg_k, pin, scale, stream)`` and ``gt_spmv_fast(slots,
raw_wts, scales, row_items, sell, table, out, v, c, seg_k, pin, scale, mul,
bf16, stream)``, commit 4fb4c8d or later: a ``struct GtSell`` that is a
prefix of today's), for example a ``git archive`` of an earlier commit
unpacked into a git-ignored directory.  The script builds it with nvcc
and, at the shapes the main path gives the kernels (C = V, seed 0; f32 and
bf16 tables, with and without the fused pin) on the blog-shaped graph (V =
10,496), R-MAT 14 (V = 16,384) and the arxiv shape (V = 38,912), on V =
60,000 at C = 8,192, on the blog-shaped graph's other streams (after an
RCM relabel its seg-1, seg-2 and seg-4 streams, as ``--relabel rcm --seg
k`` runs them, and random edge weights) and on the seg-2 streams of R-MAT
14 and the arxiv shape after RCM, runs the old build in the design it
gives the stream (the column panel where a seg-1 stream has its sliced
layout, else row tiles) and
the new build in the design ``spmv`` gives it and, with ``--force``, also
as the L2 column tiles on every seg-1 stream that has another design and
as the packed-lane panel on every uniform seg-1 stream of V <= 16,384
that has another (``--hot`` adds packed layouts whose panel holds fewer
rows, so more of the reads are cold);
times old, new, new, old with CUDA events (the median of 9 launches each)
and counts the elements where the new output differs from the old one,
all and on rows of at most SELL_HUB items (expected 0 there: the same
operations in the same order).  Each unpinned case also times one
``torch.sparse.mm`` of the folded P (its CSR, ``timing.stream_csr``, in
the table's dtype) on the same table, and ``--plain`` times the plain
PyTorch version of each
case once (the median of 3).  ``--only`` takes a comma list of stream tags
(TAGS).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from graphtpu_torch.bench import bounds
from graphtpu_torch.bench.generators import (
    BLOG_NODES,
    arxiv_shaped_graph,
    blog_shaped_edges,
    blog_shaped_graph,
    rmat14_graph,
    v60000_graph,
)
from graphtpu_torch.bench.timing import cuda_ms, stream_csr
from graphtpu_torch.kernels import _build, spmm

CASES = (  # stream, mode, dtype, table_scale
    ("blog", "kahan", torch.float32, 0.6),
    ("blog", "fast", torch.float32, 0.6),
    ("blog", "fast", torch.bfloat16, 0.6),
    ("blog", "kahan", torch.float32, None),
    ("blog", "fast", torch.float32, None),
    ("blog_seg2_rcm", "kahan", torch.float32, 0.6),
    ("blog_seg2_rcm", "fast", torch.float32, 0.6),
    ("blog_seg2_rcm", "fast", torch.bfloat16, 0.6),
    ("blog_seg2_rcm", "fast", torch.bfloat16, None),
    ("blog_seg2_rcm", "kahan", torch.float32, None),
    ("blog_seg2_rcm", "fast", torch.float32, None),
    ("blog_rcm", "kahan", torch.float32, 0.6),
    ("blog_rcm", "fast", torch.float32, 0.6),
    ("blog_rcm", "fast", torch.bfloat16, 0.6),
    ("blog_rcm", "kahan", torch.float32, None),
    ("blog_rcm", "fast", torch.float32, None),
    ("blog_rcm", "fast", torch.bfloat16, None),
    ("blog_seg4_rcm", "kahan", torch.float32, 0.6),
    ("blog_seg4_rcm", "fast", torch.float32, 0.6),
    ("blog_seg4_rcm", "fast", torch.bfloat16, None),
    ("blog_weighted", "kahan", torch.float32, 0.6),
    ("blog_weighted", "fast", torch.float32, 0.6),
    ("rmat", "kahan", torch.float32, 0.6),
    ("rmat", "fast", torch.float32, 0.6),
    ("rmat", "fast", torch.bfloat16, 0.6),
    ("rmat", "kahan", torch.float32, None),
    ("rmat", "fast", torch.float32, None),
    ("rmat", "fast", torch.bfloat16, None),
    ("arxiv", "kahan", torch.float32, 0.6),
    ("arxiv", "fast", torch.float32, 0.6),
    ("arxiv", "fast", torch.bfloat16, 0.6),
    ("arxiv", "kahan", torch.float32, None),
    ("arxiv", "fast", torch.float32, None),
    ("arxiv", "fast", torch.bfloat16, None),
    ("v60000", "kahan", torch.float32, 0.6),
    ("v60000", "fast", torch.float32, 0.6),
    ("v60000", "kahan", torch.float32, None),
    ("v60000", "fast", torch.float32, None),
) + tuple((tag, mode, dtype, ts) for tag in ("rmat_seg2_rcm", "arxiv_seg2_rcm")
          for mode, dtype in (("kahan", torch.float32), ("fast", torch.float32),
                              ("fast", torch.bfloat16))
          for ts in (0.6, None))
TAGS = ("blog", "blog_rcm", "blog_seg2_rcm", "blog_seg4_rcm", "blog_weighted", "rmat", "arxiv",
        "v60000", "rmat_seg2_rcm", "arxiv_seg2_rcm")
COLS = {"v60000": 8192}  # table columns where not C = V


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


def make_stream(tag, dev):
    """The stream of ``tag`` (one of TAGS) on ``dev``."""
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.reorder import rcm_order, relabel_graph

    def rcm(g):
        return relabel_graph(g, rcm_order(g))[0]

    if tag == "blog":
        return spmm.build_spmv_stream(blog_shaped_graph(), device=dev)
    seg = {"blog_rcm": 1, "blog_seg2_rcm": 2, "blog_seg4_rcm": 4}
    if tag in seg:
        return spmm.build_spmv_segments(rcm(blog_shaped_graph()), k=seg[tag], device=dev)
    if tag in ("rmat_seg2_rcm", "arxiv_seg2_rcm"):
        g = rmat14_graph() if tag.startswith("rmat") else arxiv_shaped_graph()
        return spmm.build_spmv_segments(rcm(g), k=2, device=dev)
    if tag == "blog_weighted":
        edges = blog_shaped_edges()
        wts = (np.random.default_rng(0).random(len(edges)) + 0.1).astype(np.float32)
        weighted = build_graph(edges, weights=wts, n_nodes=BLOG_NODES)
        return spmm.build_spmv_stream(weighted, weighted=True, device=dev)
    if tag == "rmat":
        return spmm.build_spmv_stream(rmat14_graph(), device=dev)
    if tag == "arxiv":
        return spmm.build_spmv_stream(arxiv_shaped_graph(), device=dev)
    if tag == "v60000":
        return spmm.build_spmv_stream(v60000_graph(), device=dev)
    raise ValueError(f"unknown stream {tag!r}")


def variants(stream, force: bool, hot=()):
    """The streams the new build runs, each with its label: the one ``spmv``
    is given and, with ``force``, the same stream with a tile plan where it
    has none (seg-1 streams) and with a packed layout where it has none and
    the layout takes it (uniform seg-1, V <= PACK_MAX_V); ``hot`` adds
    packed layouts whose panel holds that many rows ("packed@N")."""
    out = [(None, stream)]
    bare = spmm.row_tiles(stream)
    if force and stream.tiles is None and stream.seg_k == 1:
        out.append((None, dataclasses.replace(bare, tiles=spmm.build_tile_plan(stream))))
    packs = stream.seg_k == 1 and stream.uniform and stream.n_nodes <= spmm.PACK_MAX_V
    if force and packs and stream.packed is None:
        out.append((None, dataclasses.replace(bare, packed=spmm.build_packed_layout(stream))))
    for h in hot if packs else ():
        out.append((f"packed@{h}", dataclasses.replace(
            bare, packed=spmm.build_packed_layout(stream, hot=h))))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier kernel sources")
    ap.add_argument("--only", default=",".join(TAGS), help="comma list of stream tags")
    ap.add_argument("--force", action="store_true",
                    help="also run every other design that takes each stream")
    ap.add_argument("--plain", action="store_true", help="also time each case's plain version")
    ap.add_argument("--hot", type=lambda a: [int(h) for h in a.split(",")], default=[],
                    help="comma list of panel rows: also run packed layouts holding that many")
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    tags = args.only.split(",")
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
        for tag in tags:
            stream = make_stream(tag, dev)
            # the old build: the column panel where a seg-1 stream has its
            # layout, else row tiles
            old_st = (stream if stream.sell is not None and stream.seg_k == 1
                      else spmm.row_tiles(stream))
            runs = variants(stream, args.force, args.hot)
            v = stream.n_nodes
            c = COLS.get(tag, v)
            cnt = torch.diff(stream.row_items)
            lane = cnt <= spmm.SELL_HUB  # rows the new designs sum in the old order
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.rand((v, c), generator=gen, device=dev)
            for stag, mode, dtype, ts in CASES:
                if stag != tag:
                    continue
                table = x.to(dtype)
                old_fn = lambda: old_spmv(old, old_st, table, mode, ts)  # noqa: E731
                old_out = old_fn()
                lib = None
                if ts is None:
                    csr = stream_csr(stream, stream.wts).to(dtype)
                    lib = cuda_ms(lambda: torch.sparse.mm(csr, table))
                    del csr
                plain_ms = None
                if args.plain:
                    plain_ms = cuda_ms(lambda: spmm.spmv_plain(stream, table, mode, ts),
                                       warmup=1, runs=3)
                bound_ms, bound_by = bounds.bound(*bounds.stream_work(
                    stream, c, table.element_size(), mode, ts is not None))
                labels = set()
                for name, st in runs:
                    label = name or spmm.spmv_design(st, dtype)
                    if label in labels:
                        continue  # a tile plan does not run bf16
                    labels.add(label)
                    new_fn = lambda: spmm.spmv(st, table, mode, ts)  # noqa: E731
                    new_out = new_fn()
                    torch.cuda.synchronize()
                    diff = (new_out.float() - old_out.float()).abs().max().item()
                    ne = new_out != old_out
                    unequal, unequal_lane = int(ne.sum().item()), int(ne[lane].sum().item())
                    del new_out, ne
                    t = [cuda_ms(old_fn), cuda_ms(new_fn), cuda_ms(new_fn), cuda_ms(old_fn)]
                    r = dict(graph=tag, mode=mode, dtype=str(dtype).split(".")[-1],
                             pin=ts is not None, width=c, design=label,
                             old_design=spmm.spmv_design(old_st), old_ms=[t[0], t[3]],
                             new_ms=[t[1], t[2]], max_abs_diff=diff, unequal=unequal,
                             unequal_lane_rows=unequal_lane, library_ms=lib,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    rows.append(r)
                    print(f"{tag} {mode} {r['dtype']} pin={r['pin']} C={c}: old "
                          f"({r['old_design']}) {t[0]:.3f}/{t[3]:.3f} ms, new ({label}) "
                          f"{t[1]:.3f}/{t[2]:.3f} ms; max |new-old| {diff:.3e}, {unequal} "
                          f"unequal elements ({unequal_lane} on rows of <= {spmm.SELL_HUB} "
                          "items)" + ("" if lib is None else f"; torch.sparse.mm {lib:.3f} ms")
                          + ("" if plain_ms is None else f"; plain {plain_ms:.3f} ms")
                          + f"; bound {bound_ms:.3f} ms ({bound_by})", flush=True)
                del old_out, table
            del x, stream, runs, old_st
            torch.cuda.empty_cache()
    res = dict(card=card, cases=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
