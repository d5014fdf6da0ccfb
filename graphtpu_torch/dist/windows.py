"""Batched source windows with streamed flush and checkpoint/resume
(counterpart of ``graphtpu/dist/windows.py``).

The reference bounds memory by processing sources in windows: a Giraph
MasterCompute broadcasts a [VID_LOWER, VID_UPPER] window every CYCLE
supersteps (``giraph/SingleWalkMasterCompute.java:29-35``); in-window
vertices run their walks, flush their top-k to part files and vote to halt
(``giraph/BatchSingleWalkVertex.java:108-133``).  Here each window's top-k
goes to its own part file and a JSON cursor is replaced atomically after
it, so a killed job loses at most one window.  The part-file names and the
cursor (``next_window_start``, ``n_sources``) are graphtpu's, so a sweep
directory either package started resumes in the other.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np

from graphtpu_torch.core.prng import key_for
from graphtpu_torch.io.simfile import read_sim_file, write_topk_files
from graphtpu_torch.utils.metrics import StepMetrics

TileFn = Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def windowed_topk_sweep(
    compute_tile: TileFn,
    n_sources: int,
    out_dir: str,
    window: int = 40000,
    key: Optional[int] = None,
    resume: bool = True,
    metrics: Optional[StepMetrics] = None,
    precision: int = 6,
) -> str:
    """Run ``compute_tile(sources, key_for(key, lo)) -> (vals, idx)`` (host
    arrays) over source windows; returns the directory holding the part
    files and the checkpoint.  ``window`` defaults to the flagship run's
    BATCH = 40000 (``CombineBatchSingleWalkVertexReuse.java:41``)."""
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "checkpoint.json")
    lo = 0
    if resume and os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            lo = json.load(f)["next_window_start"]
    key = 0 if key is None else key
    while lo < n_sources:
        hi = min(lo + window, n_sources)
        sources = np.arange(lo, hi, dtype=np.int32)
        with metrics.step(f"window[{lo}:{hi}]") if metrics else contextlib.nullcontext():
            vals, idx = compute_tile(sources, key_for(key, lo))
            part = os.path.join(out_dir, f"part-{lo:010d}")
            write_topk_files(part, idx, vals, sources=sources, precision=precision)
            # window complete -> durable cursor (the voteToHalt + flush analog)
            tmp = ckpt_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"next_window_start": hi, "n_sources": n_sources}, f)
            os.replace(tmp, ckpt_path)
        lo = hi
    return out_dir


def read_sweep_results(out_dir: str):
    """Merge all part ``.sim.txt`` files into one {source: [(nbr, val)]} dict."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("part-") and name.endswith(".sim.txt"):
            out.update(read_sim_file(os.path.join(out_dir, name)))
    return out
