"""The host-side C++ layer: the edge-list parser (``edgelist.cpp``) and the
multithreaded, Bloom-deduplicated graph generator (``generate.cpp``),
bound with ``ctypes`` (counterpart of ``graphtpu/native/``).

At first use ``g++`` builds both sources, with the flags of graphtpu's
``native/Makefile``, into one shared library under ``native/_build/``
(git-ignored), named by a hash of the sources, the flags and the host CPU's
model and feature flags (a library built on another machine may use
instructions this one lacks); it builds into a temporary file and renames
it, so processes that build at once do not clash.  A missing compiler or
a failed build raises with the compiler's output, and a failed parse or
generation raises: nothing falls back to the numpy versions
(:func:`graphtpu_torch.io.edgelist.read_edgelist_numpy`,
``massive_bipartite_graph(use_native=False)``), which callers choose
themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC / "_build"
SOURCES = ("edgelist.cpp", "generate.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread"]

_lib = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: graphtpu_torch's C++ parser and "
                           "generator cannot be built")
    return cxx


def _cpu_key() -> str:
    """The host CPU as ``-march=native`` sees it: the machine, and on Linux
    the first processor's model and feature flags (read, not compiled, so
    loading a built library needs no compiler)."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            head = f.read().split("\n\n", 1)[0]
    except OSError:
        return key + platform.processor()
    for line in head.splitlines():
        name, _, value = line.partition(":")
        if name.strip() in ("model name", "flags", "Features", "CPU part"):
            key += "|" + value.strip()
    return key


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + [_cpu_key()]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libgraphtpu_torch_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, "-shared", "-o", tmp, *(str(SRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The library, built at first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.gt_parse_edgelist.restype = ctypes.c_longlong
    lib.gt_parse_edgelist.argtypes = [
        ctypes.c_char_p,                   # path
        ctypes.c_char,                     # delimiter (0 = space, tab or comma)
        i64p, i64p,                        # out: src, dst
        ctypes.POINTER(ctypes.c_float),    # out: weights
        ctypes.POINTER(ctypes.c_int),      # out: has_weights
        ctypes.c_longlong,                 # capacity
    ]
    lib.gt_generate_graph.restype = ctypes.c_longlong
    lib.gt_generate_graph.argtypes = [
        ctypes.c_char_p,                   # path
        ctypes.c_longlong,                 # n_left
        ctypes.c_longlong,                 # n_right
        ctypes.c_longlong,                 # target edges
        ctypes.c_int,                      # mode: 0 bipartite, 1 undirected, 2 directed
        ctypes.c_ulonglong,                # seed
        ctypes.c_int,                      # threads (0 = all cores)
    ]
    _lib = lib
    return lib


def parse_edgelist(
    path: str, delimiter: Optional[str] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(edges int64 [E, 2], weights float32 [E] or None) of a
    ``src SEP dst [SEP weight]`` file, parsed by the C++ tokenizer.

    Each line is read on its own: ``delimiter`` None takes any run of
    spaces, tabs and commas as the separator, a given one also spaces and
    tabs; a line that does not start with two integers is skipped (blank
    lines, ``#`` comments); a line without a weight gets 1.0, and weights
    are returned if any line had one."""
    lib = load()
    nbytes = os.path.getsize(path)
    cap = max(nbytes // 4 + 16, 16)  # one edge needs >= 4 bytes ("a b\n")
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    wts = np.empty(cap, dtype=np.float32)
    has_w = ctypes.c_int(0)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    n = lib.gt_parse_edgelist(
        os.fsencode(path), ctypes.c_char((delimiter or "\0")[0].encode()),
        src.ctypes.data_as(i64p), dst.ctypes.data_as(i64p),
        wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(has_w), cap,
    )
    if n < 0:
        raise OSError(f"the C++ edge-list parser could not read {path}")
    edges = np.stack([src[:n], dst[:n]], axis=1)
    return edges, (wts[:n].copy() if has_w.value else None)


GEN_MODES = {"bipartite": 0, "uniform": 1, "directed": 2}


def generate_graph(
    path: str,
    mode: str,
    n_left: int,
    n_right: int = 0,
    target_edges: int = 0,
    seed: int = 0,
    threads: int = 0,
) -> int:
    """Stream ``target_edges`` distinct random edges to ``path`` as
    ``src dst`` lines with the multithreaded C++ generator (the role of
    ``GraphGeneratorBf``); returns the edges written.  ``mode``:
    "bipartite" (right ids offset by ``n_left``), "uniform" (undirected,
    no self-loops) or "directed".  A Bloom false positive drops a new edge
    (under 2% at its bit budget), never lets a duplicate through; which
    edges are drawn depends on the threads' timing."""
    if mode not in GEN_MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(GEN_MODES)}")
    n = load().gt_generate_graph(os.fsencode(path), n_left, n_right, target_edges,
                                 GEN_MODES[mode], seed, threads)
    if n < 0:
        raise ValueError(
            f"generate_graph({mode!r}, n_left={n_left}, n_right={n_right}, "
            f"target_edges={target_edges}): invalid sizes (the key space must hold at least "
            f"twice the edges) or {path} could not be written")
    return int(n)
