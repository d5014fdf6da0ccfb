"""Kernels B1/B2's packed-lane panel on R-MAT 14 (and forced on the
blog-shaped graph), its time split into parts.

    python -m graphtpu_torch.bench.packed_split [--out f.json]

It builds copies of ``csrc/spmv.cu`` with one part of the packed kernel
cut (``CUTS``: the cold items' table reads, the producer's L2 prefetch,
every panel and table read, the flushes' stores, the pieces' join, the
panel's copy-in) and times each, with CUDA events, on the same layout
beside the whole kernel, for B1 pinned and B2 f32 and bf16 unpinned (C =
V, seed 8): what a part costs is the whole's time less the cut one's (a
cut kernel's output is wrong, and is not looked at).  A cut whose text
``spmv.cu`` no longer has raises.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from graphtpu_torch.bench.generators import blog_shaped_graph, rmat14_graph
from graphtpu_torch.bench.timing import card, cuda_ms
from graphtpu_torch.kernels import _build, spmm

SPLIT = (  # mode, dtype, table_scale: B1 pinned, B2 f32 and bf16 unpinned
    ("kahan", torch.float32, 0.6), ("fast", torch.float32, None),
    ("fast", torch.bfloat16, None),
)
# part -> (text of csrc/spmv.cu, its replacement)
CUTS = {
    "cold reads": [("      if (__any_sync(0xffffffffu, any & kPackCold)) {", "      if (false) {")],
    "L2 prefetch": [("      n = ch < L.n_chunks ? min(__ldg(L.cold_beg + ch + 1) - beg, "
                     "kPackPrefetch) : 0;", "      n = 0;")],
    "all reads": [("      if (__any_sync(0xffffffffu, any & kPackCold)) {", "      if (false) {"),
                  ("        raw[q] = *reinterpret_cast<const uint4*>(panel + min(code[q], last) "
                   "* kSlab);", "        raw[q] = make_uint4(code[q], code[q] ^ 1, code[q] ^ 2, "
                   "code[q] ^ 3);")],
    "stores": [("    if (row >= 0) {\n      if (SCALE) {",
                "    if (row >= 0 && sum[0] == -12345.f) {\n      if (SCALE) {"),
               ("    } else if (row < -1) {\n      float* h = L.hub_acc",
                "    } else if (row < -1 && sum[0] == -12345.f) {\n      float* h = L.hub_acc")],
    "join": [("  hub_rows_out<T, KAHAN, SCALE, Op::kSum>(L, out, col0, c, vec_here);\n", "")],
    "copy-in": [("        gt::cp_async16(dst, table + (size_t)r[k] * (size_t)c + col0);",
                 "        (void)dst;")],
}


def cut_library(part: str, out_dir: str) -> ctypes.CDLL:
    """``csrc/spmv.cu`` with ``part`` cut, built into ``out_dir``."""
    src = (_build.CSRC / "spmv.cu").read_text()
    for old, new in CUTS[part]:
        if old not in src:
            raise RuntimeError(f"cut {part!r}: spmv.cu no longer has {old!r}")
        src = src.replace(old, new)
    d = Path(out_dir) / part.replace(" ", "_")
    d.mkdir()
    for f in _build.CSRC.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    (d / "spmv.cu").write_text(src)
    _build.compile_library([str(d / "spmv.cu")], str(d / "lib.so"))
    lib = ctypes.CDLL(str(d / "lib.so"))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.gt_spmv_packed.argtypes = [ctypes.POINTER(_build.GtPacked), p, p, i64, i64, i32, i32,
                                   f32, i32, p]
    return lib


def packed_ms(lib, lay, table, mode, table_scale) -> float:
    """Time of ``lib``'s packed kernel over ``lay`` (output discarded)."""
    v, c = table.shape
    out = torch.empty((v + 1, c), dtype=table.dtype, device=table.device)
    args, acc = spmm.packed_launch_args(lay, c, mode == "kahan", table.device)  # acc: held
    pin = table_scale is not None

    def run():
        cu = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.gt_spmv_packed(args, table.data_ptr(), out.data_ptr(), v, c,
                                int(mode == "kahan"), int(pin),
                                ctypes.c_float(table_scale if pin else 0.0),
                                int(table.dtype == torch.bfloat16), cu)
        if rc:
            raise RuntimeError(f"packed launch failed: {rc}")

    return cuda_ms(run)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("packed_split times the card's kernels: it needs CUDA")
    dev = torch.device("cuda")
    res = dict(card=card())
    print(res["card"], flush=True)
    whole = _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(CUTS)) as ex:
            libs = dict(zip(CUTS, ex.map(lambda p: cut_library(p, tmp), CUTS)))
        rmat = spmm.build_spmv_stream(rmat14_graph(), device=dev)
        blog = spmm.build_spmv_stream(blog_shaped_graph(), device=dev)
        blog = spmm.with_layout(blog, spmm.build_packed_layout(blog))
        for tag, st in (("rmat", rmat), ("blog", blog)):
            lay = st.layout
            print(f"{tag}: design {spmm.spmv_design(st)}, {lay.n_chunks} chunks, "
                  f"{lay.n_pieces} pieces, layout {lay.host_ms:.1f} ms (host)", flush=True)
            x = torch.rand((st.n_nodes, st.n_nodes), generator=torch.Generator(device=dev)
                           .manual_seed(8), device=dev)
            split = []
            for mode, dtype, ts in SPLIT:
                table = x.to(dtype)
                r = dict(mode=mode, dtype=str(dtype).split(".")[-1], pin=ts is not None,
                         whole_ms=packed_ms(whole, lay, table, mode, ts))
                r["cut_ms"] = {p: packed_ms(lib, lay, table, mode, ts) for p, lib in libs.items()}
                split.append(r)
                print(f"  {mode} {r['dtype']} pin={r['pin']}: whole {r['whole_ms']:.3f} ms; "
                      "without " + ", ".join(f"{p} {t:.3f}" for p, t in r["cut_ms"].items()),
                      flush=True)
                del table
            res[tag] = split
            del x
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
