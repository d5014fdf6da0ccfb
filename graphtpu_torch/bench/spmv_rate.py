"""Item-rate probe of the streaming SpMV kernels (counterpart of
``tools/exp_spmv_rate.py``).

    python -m graphtpu_torch.bench.spmv_rate [--out rate.json]

On the item streams of the blog-shaped and R-MAT graphs (seed 0), at C = V
columns of random f32 values, it times kernel B1 (kahan), B2 (fast, f32 and
bf16 tables), each in the design the stream gives it (the column panel at
blog, the packed-lane panel at R-MAT), and three stripped variants of B2,
the hand kernels of ``kernels/csrc/spmv_rate.cu``:

* X1 :func:`gather_only` — every item's row is read, nothing accumulated:
  ``out[r] = max over r's items of table[slot]``;
* X2 :func:`accumulate_only` — per-item control and weighted accumulation
  from a resident [16, C] buffer, no row reads:
  ``out[r] = Σ_{t in r} wts[t]·buf[t mod 16]``;
* X3 :func:`unroll8` — raw, unweighted, unscaled run sums
  ``out[r] = Σ_{t in r} table[slot]``, in B2's design with more loads in
  flight.

It prints ns per stream item and the rate of row reads for each, the
median of 9 timed runs, the design each kernel ran and, for the panel
designs, ns per chunk of their layout and 16-byte slab (a block walks every
chunk once for its slab).  The streams are built on the card with their
sliced layout where B2's column panel takes them (blog; not R-MAT), and
the rate kernels run the design the stream gives them (:func:`design`).
At blog that is B2's column panel: X1 is the panel
with a max in place of the add (its reads alone), X2 the panel's launch,
ring and walk with each item's term taken from a buffer in registers (its
per-item work alone, no panel), X3 the panel with 16 items in flight
instead of 8 and no row scale; so B2 − X2 is what the panel's copy-in and
reads cost, X1 against B2 what its arithmetic costs, and X3 beside B2
whether more reads in flight move it.  At R-MAT they run row tiles, a
block per (output row, 1,024-column tile): X1 with 4 loads in flight a
thread, X3 with 8, X2 with its buffer tile in registers; and X2 runs once
more over R-MAT's sliced layout (:func:`build_sell_layout`, whose table
does not fit the panel: X2 reads none), which gives that layout's walk,
flushes and hub join without panel reads, beside blog's.
``dataclasses.replace(stream, sell=None)`` forces row tiles.  Each
wrapper runs its plain PyTorch version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises; the probe itself needs a card.  The
TPU tool's ring-depth and block-size grid and its transpose timings are
TPU staging and have no counterpart here.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
from typing import Dict, List

import torch

from graphtpu_torch.bench.generators import blog_shaped_graph, rmat14_graph
from graphtpu_torch.bench.timing import cuda_ms
from graphtpu_torch.kernels.spmm import (
    SpmvStream,
    build_sell_layout,
    build_spmv_stream,
    row_tiles,
    scatter_rows_plain,
    sell_launch_args,
    spmv,
    spmv_design,
)

# kernel launches, counted where a wrapper launches its kernel
RATE_LAUNCHES = {"gather_only": 0, "accumulate_only": 0, "unroll8": 0}
N_BUF = 16  # rows of X2's resident buffer
GRAPHS = {"blog": blog_shaped_graph, "rmat": rmat14_graph}
RUNS = 9  # timed runs per kernel
SEED = 0  # of the graphs and the values


def _check(stream: SpmvStream, x: torch.Tensor, min_rows: int) -> None:
    if stream.seg_k != 1:
        raise ValueError(f"the rate variants walk item streams (seg_k 1), got {stream.seg_k}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"expected a 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < min_rows:
        raise ValueError(f"tensor has {x.shape[0]} rows, the stream reads {min_rows}")


def _plain(stream: SpmvStream, x: torch.Tensor, rows_of, reduce: str) -> torch.Tensor:
    """[V+1, C] f32: ``rows_of(lo, hi)`` gives each item's [T, hi-lo] row
    block, reduced into its output row by ``reduce`` ("sum" or "amax")."""
    pos = stream.pos.to(x.device, torch.int64)
    return scatter_rows_plain(pos, stream.n_nodes + 1, x.shape[1], pos.numel(),
                              rows_of, reduce)


def gather_only_plain(stream: SpmvStream, table: torch.Tensor) -> torch.Tensor:
    """Plain version of X1: each row's max over its items' table rows."""
    slots = stream.slots.to(table.device, torch.int64)
    return _plain(stream, table, lambda lo, hi: table[slots, lo:hi], "amax")


def accumulate_only_plain(stream: SpmvStream, buf: torch.Tensor) -> torch.Tensor:
    """Plain version of X2: Σ_{t in r} wts[t]·buf[t mod 16]."""
    t = torch.arange(stream.slots.numel(), device=buf.device)
    w = stream.wts.to(buf.device)[:, None]
    return _plain(stream, buf, lambda lo, hi: w * buf[t % N_BUF, lo:hi], "sum")


def unroll8_plain(stream: SpmvStream, table: torch.Tensor) -> torch.Tensor:
    """Plain version of X3: raw run sums Σ_{t in r} table[slots[t]]."""
    slots = stream.slots.to(table.device, torch.int64)
    return _plain(stream, table, lambda lo, hi: table[slots, lo:hi], "sum")


def design(name: str, stream: SpmvStream) -> str:
    """The design kernel ``name`` (a key of RATE_LAUNCHES) runs on
    ``stream``: "panel" over a stream with a sliced layout, as B2 does,
    else "rows"."""
    if name not in RATE_LAUNCHES:
        raise ValueError(f"unknown rate kernel {name!r}")
    return "panel" if stream.sell is not None else "rows"


def _launch(name: str, stream: SpmvStream, first: torch.Tensor, x: torch.Tensor):
    from graphtpu_torch.kernels import _build

    if not x.is_contiguous():
        raise ValueError("table and buffer must be contiguous")
    lay = stream.sell
    fields = (first, stream.row_items) + (() if lay is None else (
        lay.slots, lay.lane_row, lay.lane_cnt, lay.lane_base, lay.unit_hub, lay.ss_chunks,
        lay.hub_rows, lay.hub_piece, lay.row_wts, lay.row_scale))
    for f in fields:
        if f.device != x.device or not f.is_contiguous():
            raise ValueError("stream tensors must be contiguous on the table's device")
    v, c = stream.n_nodes, x.shape[1]
    out = torch.empty((v + 1, c), dtype=torch.float32, device=x.device)
    if c == 0:
        return out
    lib = _build.load()
    fn = getattr(lib, f"gt_rate_{name}")
    # the panel's layout and scratch, held until the launch is enqueued; X2
    # weighs each item by its row's folded weight
    sell = hub_acc = None
    if design(name, stream) == "panel":
        sell, hub_acc = sell_launch_args(lay, c, name == "accumulate_only", x.device)
    with torch.cuda.device(x.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(first.data_ptr(), stream.row_items.data_ptr(), sell, x.data_ptr(),
                out.data_ptr(), v + 1, c, cu_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_build.error_string(rc)}")
    RATE_LAUNCHES[name] += 1
    return out


def _dispatch(name, plain, stream, first, x):
    if x.device.type == "cpu":
        return plain(stream, x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {x.device}")
    return _launch(name, stream, first, x)


def gather_only(stream: SpmvStream, table: torch.Tensor) -> torch.Tensor:
    """X1 over ``stream``: [>=V, C] f32 -> [V+1, C] f32; on the card, B2's
    column panel with a max where the stream has a sliced layout, else row
    tiles."""
    _check(stream, table, stream.n_nodes)
    return _dispatch("gather_only", gather_only_plain, stream, stream.slots, table)


def accumulate_only(stream: SpmvStream, buf: torch.Tensor) -> torch.Tensor:
    """X2 over ``stream``: buf [16, C] f32 -> [V+1, C] f32; on the card, B2's
    panel launch reading no panel where the stream has a sliced layout,
    else row tiles."""
    _check(stream, buf, N_BUF)
    return _dispatch("accumulate_only", accumulate_only_plain, stream, stream.wts, buf)


def unroll8(stream: SpmvStream, table: torch.Tensor) -> torch.Tensor:
    """X3 over ``stream``: [>=V, C] f32 -> [V+1, C] f32; on the card, B2's
    column panel over the stream's sliced layout where it has one, else
    row tiles."""
    _check(stream, table, stream.n_nodes)
    return _dispatch("unroll8", unroll8_plain, stream, stream.slots, table)


def probe(stream: SpmvStream, table: torch.Tensor, buf: torch.Tensor) -> List[Dict]:
    """Time the six kernels on one stream: one row per kernel with its
    design, ms, ns per stream item and GB/s of table-row reads."""
    items = stream.slots.numel()
    c = table.shape[1]
    table16 = table.bfloat16()
    b, b16 = spmv_design(stream), spmv_design(stream, torch.bfloat16)
    cases = [
        ("B1 kahan", b, lambda: spmv(stream, table, "kahan"), 4),
        ("B2 fast f32", b, lambda: spmv(stream, table, "fast"), 4),
        ("B2 fast bf16", b16, lambda: spmv(stream, table16, "fast"), 2),
        ("X1 gather only", design("gather_only", stream), lambda: gather_only(stream, table), 4),
        ("X2 accumulate only", design("accumulate_only", stream),
         lambda: accumulate_only(stream, buf), 0),
        ("X3 unroll", design("unroll8", stream), lambda: unroll8(stream, table), 4),
    ]
    walks = {"panel": stream.sell, "packed": stream.packed}
    if stream.sell is None and stream.uniform:
        # X2 over the sliced layout of a stream whose table no panel holds
        sliced = dataclasses.replace(row_tiles(stream), sell=build_sell_layout(stream))
        walks["panel"] = sliced.sell
        cases.append(("X2 sliced layout", "panel", lambda: accumulate_only(sliced, buf), 0))
    rows = []
    for name, used, fn, elem_bytes in cases:
        ms = cuda_ms(fn, runs=RUNS)
        row = dict(kernel=name, design=used, ms=ms, ns_per_item=ms * 1e6 / items,
                   read_gb_per_s=items * c * elem_bytes / (ms * 1e6))
        if walks.get(used) is not None:
            # every block walks every chunk of the layout once for its
            # 16-byte slab (4 f32 or 8 bf16 columns)
            slabs = -(-c // (8 if elem_bytes == 2 else 4))
            row["chunks"] = walks[used].n_chunks
            row["ns_per_chunk_slab"] = ms * 1e6 / (row["chunks"] * slabs)
        rows.append(row)
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    return ap.parse_args(argv)


def run(device) -> Dict:
    """Probe each graph's stream at C = V on ``device``; print and return
    the rows."""
    results = {"graphs": {}}
    for name, make in GRAPHS.items():
        g = make(seed=SEED)
        stream = build_spmv_stream(g, device=device)
        v = g.n_nodes
        gen = torch.Generator(device=device).manual_seed(SEED)
        table = torch.rand((v, v), generator=gen, device=device)
        buf = torch.rand((N_BUF, v), generator=gen, device=device)
        rows = probe(stream, table, buf)
        del table, buf
        items = stream.slots.numel()
        results["graphs"][name] = dict(V=v, C=v, items=items, slots=g.n_edges, rows=rows)
        print(f"{name}: V = C = {v}, {items} stream items, {g.n_edges} CSR slots, "
              f"max degree {g.max_degree}", flush=True)
        for r in rows:
            print(f"  {r['kernel']:<20} {r['design']:<5} {r['ms']:9.3f} ms "
                  f"{r['ns_per_item']:8.3f} ns/item {r['read_gb_per_s']:8.1f} GB/s of row reads"
                  + ("" if "chunks" not in r else
                     f" {r['ns_per_chunk_slab']:7.3f} ns per chunk and slab "
                     f"({r['chunks']} chunks)"),
                  flush=True)
    return results


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the item-rate probe times the card's kernels: it needs CUDA")
    results = run(torch.device("cuda"))
    results["device"] = torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
