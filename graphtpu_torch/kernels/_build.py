"""Build and bind the hand CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


class GtSell(ctypes.Structure):
    """``struct GtSell`` of ``csrc/spmv.cu``: a sliced layout's device
    pointers and sizes, and the launch's scratch for hub rows."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "slots", "lane_row", "lane_cnt", "unit_hub", "ss_chunks", "hub_rows",
        "hub_piece", "row_w", "hub_acc")] + [
        (n, ctypes.c_int64) for n in ("n_chunks", "n_ss", "n_hub", "n_pieces")]


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


def build() -> Path:
    """Compile the kernels unless a library of the same hash exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        build_log = proc.stdout + proc.stderr
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
    lib.gt_gather_rows_sum.argtypes = [p, p, p, i64, p, i64, i64, i32, i64, i32, p]
    lib.gt_gather_rows_sum.restype = ctypes.c_int
    for name in ("gt_rate_gather_only", "gt_rate_accumulate_only", "gt_rate_unroll8"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.gt_error_string.argtypes = [ctypes.c_int]
    lib.gt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().gt_error_string(code).decode()})"
