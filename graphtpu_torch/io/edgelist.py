"""Edge-list text parsing.

Whitespace- or comma-separated ``src dst [weight]`` lines.
:func:`read_edgelist` parses with the C++ tokenizer of
:mod:`graphtpu_torch.native`, which reads each line on its own;
:func:`read_edgelist_numpy`, its plain version, sniffs the delimiter and
the column count from the first line.  The two agree on every format the
repository writes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _sniff_delimiter(line: str) -> Optional[str]:
    for cand in (",", "\t", " "):
        if cand in line:
            return cand if cand != " " else None  # None => any whitespace
    return None


def read_edgelist(
    path: str, delimiter: Optional[str] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Return (edges int64[E,2], weights float32[E] or None), parsed by the
    C++ tokenizer (:func:`graphtpu_torch.native.parse_edgelist`)."""
    from graphtpu_torch.native import parse_edgelist

    return parse_edgelist(path, delimiter)


def read_edgelist_numpy(
    path: str, delimiter: Optional[str] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """:func:`read_edgelist` in numpy: the delimiter (when not given) and
    the column count come from the first line."""
    with open(path, "r") as f:
        first = f.readline()
    if not first.strip():
        return np.zeros((0, 2), dtype=np.int64), None
    if delimiter is None:
        delimiter = _sniff_delimiter(first)
    ncols = len(first.split(delimiter))
    data = np.loadtxt(path, delimiter=delimiter, dtype=np.float64, ndmin=2)
    edges = data[:, :2].astype(np.int64)
    wts = data[:, 2].astype(np.float32) if ncols >= 3 and data.shape[1] >= 3 else None
    return edges, wts


def write_edgelist(
    path: str,
    edges: np.ndarray,
    weights: Optional[np.ndarray] = None,
    delimiter: str = " ",
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    edges = np.asarray(edges)
    with open(path, "w") as f:
        if weights is None:
            for s, d in edges:
                f.write(f"{int(s)}{delimiter}{int(d)}\n")
        else:
            for (s, d), w in zip(edges, np.asarray(weights)):
                f.write(f"{int(s)}{delimiter}{int(d)}{delimiter}{w:g}\n")
