"""Build and bind the hand CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, named by a hash of the sources,
their shared headers (``csrc/*.cuh``) and the flags, under
``kernels/_build/`` (git-ignored); ``ctypes`` loads it.
A missing ``nvcc`` or a failed build raises with the compiler's output:
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


class GtSell(ctypes.Structure):
    """``struct GtSell`` of ``csrc/panel.cuh``: a sliced layout's device
    pointers and sizes, and the launch's scratch for hub rows."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "slots", "lane_row", "lane_cnt", "unit_hub", "ss_chunks", "hub_rows",
        "hub_piece", "row_w", "hub_acc")] + [
        (n, ctypes.c_int64) for n in ("n_chunks", "n_ss", "n_hub", "n_pieces")] + [
        ("lane_base", ctypes.c_void_p)]


class GtPacked(ctypes.Structure):
    """``struct GtPacked`` of ``csrc/spmv.cu``: the packed-lane panel's
    layout (:class:`graphtpu_torch.kernels.spmm.PackedLayout`) and scratch."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "codes", "hot_rows", "row_code", "cold_beg", "cold_rows", "lane_row", "lane_cnt",
        "lane_w", "warp_units", "hub_rows", "hub_piece", "row_w", "empty_rows", "hub_acc")] + [
        (n, ctypes.c_int64) for n in ("n_chunks", "n_hot", "n_hub", "n_pieces", "n_empty")]


class GtTiles(ctypes.Structure):
    """``struct GtTiles`` of ``csrc/spmv.cu``: the L2 column tiles' plan
    (:class:`graphtpu_torch.kernels.spmm.TilePlan`) and its scratch."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "hub_rows", "hub_piece", "piece_row", "piece_beg", "acc")] + [
        (n, ctypes.c_int64) for n in ("n_hub", "n_pieces", "hub")]


class GtGather(ctypes.Structure):
    """``struct GtGather`` of ``csrc/gather.cu``: a tree level's compact
    plan (:class:`graphtpu_torch.kernels.spmm.GatherLayout`) on the card."""

    _fields_ = [("chunks", ctypes.c_void_p)] + [
        (n, ctypes.c_int64) for n in ("n_chunks", "n_table")]


build_log = ""  # nvcc's output (ptxas register/spill report) from the last build


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of graphtpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgraphtpu_torch_kernels-{h.hexdigest()[:16]}.so"


def compile_library(sources, out: str) -> str:
    """nvcc each of ``sources`` into an object, all at once, then link them
    into the shared library ``out``; returns the compilers' output (the
    ptxas register and spill report) or raises with it."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, f"{i}_{Path(src).stem}.o") for i, src in enumerate(sources)]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]  # every process ends before a raise
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {src}:\n{log}")
        link = [nvcc, "-shared", "-o", out, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
    return "".join(logs)


def build() -> Path:
    """Compile the kernels unless a library of the same hash exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        build_log = compile_library(_sources(), tmp)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    sell = ctypes.POINTER(GtSell)
    lib.gt_spmv_kahan_f32.argtypes = [p, p, p, sell, p, p, i64, i64, i32, i32, f32, p]
    lib.gt_spmv_kahan_f32.restype = ctypes.c_int
    lib.gt_spmv_fast.argtypes = [p, p, p, p, sell, p, p, i64, i64, i32, i32, f32, i32, i32, p]
    lib.gt_spmv_fast.restype = ctypes.c_int
    lib.gt_spmv_tiles.argtypes = [p, p, p, p, ctypes.POINTER(GtTiles), p, p, i64, i64, i32, f32,
                                  i32, i32, p]
    lib.gt_spmv_tiles.restype = ctypes.c_int
    lib.gt_spmv_packed.argtypes = [ctypes.POINTER(GtPacked), p, p, i64, i64, i32, i32, f32, i32,
                                   p]
    lib.gt_spmv_packed.restype = ctypes.c_int
    lib.gt_gather_rows_sum.argtypes = [p, p, p, i64, i32, p, i64, i64, i32, i64, i32,
                                       ctypes.POINTER(GtGather), p]
    lib.gt_gather_rows_sum.restype = ctypes.c_int
    for name in ("gt_rate_gather_only", "gt_rate_accumulate_only", "gt_rate_unroll8"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, sell, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.gt_transpose_2d.argtypes = [p, p, i64, i64, i32, p]
    lib.gt_transpose_2d.restype = ctypes.c_int
    lib.gt_topk_rows.argtypes = [p, p, p, i64, i64, i32, i32, i64, p]
    lib.gt_topk_rows.restype = ctypes.c_int
    lib.gt_expand_frontier.argtypes = [p, p, p, p, i32, p, i64, p, p, p, p, i64, i64, i64, i32,
                                       i32, p]
    lib.gt_expand_frontier.restype = ctypes.c_int
    lib.gt_sg1_coeffs.argtypes = [p] * 9 + [i64] * 5 + [p]
    lib.gt_sg1_coeffs.restype = ctypes.c_int
    lib.gt_sg1_rows.argtypes = [p] * 10 + [i64] * 6 + [p]
    lib.gt_sg1_rows.restype = ctypes.c_int
    lib.gt_error_string.argtypes = [ctypes.c_int]
    lib.gt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().gt_error_string(code).decode()})"
