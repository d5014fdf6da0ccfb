"""word2vec text ``.emb`` format (a copy of ``graphtpu/io/embfile.py``).

Header line ``<count> <dim>``, then one ``<label> <f1> ... <fdim>`` line per
node — the format gensim's ``save_word2vec_format`` writes and
``KeyedVectors.load_word2vec_format`` reads back
(``node2vec/src/main.py:98``, ``node2vec/src/classify.py:181``,
sample: ``node2vec/emb/karate.emb:1``).  Values are written ``%f`` (6dp) to
match the samples; labels may be arbitrary strings (node names).

The writer builds the file as one uint8 array by whole-array numpy passes,
as ``io/simfile.py`` builds the top-k files: a float32 value times 10**p is
exact in float64, so ``rint`` of its magnitude gives the digits of
``f"{x:.{p}f}"``, ties to even as Python rounds them, and the sign is the
value's own sign bit (``-0.0`` and negatives that round to zero print
``-0.000000``, as Python prints them).  Rows that cannot be proven so (not
finite, too large, or values that are not float32) go through the
per-value loop and keep its bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _python_line(label: bytes, row, precision: int) -> bytes:
    vals = " ".join(f"{float(x):.{precision}f}" for x in row)
    return label + b" " + vals.encode() + b"\n"


def _emb_text(emb: np.ndarray, labels: List[bytes], precision: int) -> List:
    """The lines of the rows, as buffers in order (a uint8 block for the
    rows the array passes take, bytes for each row the loop takes)."""
    from graphtpu_torch.io.simfile import _MAX_PRECISION, _narrow, _put_digits, _width

    n, d = emb.shape
    ok = np.zeros(n, bool)
    arrays = (np.can_cast(emb.dtype, np.float32) and isinstance(precision, (int, np.integer))
              and not isinstance(precision, bool) and 0 <= precision <= _MAX_PRECISION)
    if arrays and n and d:
        x = emb.astype(np.float64)
        scaled = np.rint(np.abs(x) * 10.0 ** precision)
        ok = (np.isfinite(scaled) & (scaled < 2.0 ** 53)).all(1)
    if not ok.any():
        return [_python_line(lab, row, precision) for lab, row in zip(labels, emb)]
    rows = np.flatnonzero(ok)
    neg = np.signbit(x[rows])
    q, unit = scaled[rows].astype(np.int64), 10 ** precision
    quot = q // unit
    frac, quot = _narrow(q - quot * unit), _narrow(quot)
    # a row: the label, then d fields " [-]int[.frac]", then a newline
    lab_len = np.array([len(labels[i]) for i in rows], np.int64)
    wl, wi = int(lab_len.max()), _width(quot)
    we = 2 + wi + (1 + precision if precision else 0)
    block = np.empty((rows.size, wl + d * we + 1), np.uint8)
    mask = np.ones(block.shape, bool)
    flat = np.frombuffer(b"".join(labels[i] for i in rows), np.uint8)
    at_row = np.repeat(np.arange(rows.size), lab_len)
    at_col = np.arange(flat.size) - np.repeat(np.cumsum(lab_len) - lab_len, lab_len)
    block[at_row, at_col] = flat
    mask[:, :wl] = np.arange(wl)[None, :] < lab_len[:, None]
    body = block[:, wl:wl + d * we].reshape(rows.size, d, we)
    body_mask = mask[:, wl:wl + d * we].reshape(rows.size, d, we)
    body[..., 0] = ord(" ")
    body[..., 1] = ord("-")
    body_mask[..., 1] = neg
    _put_digits(body[..., 2:2 + wi], body_mask[..., 2:2 + wi], quot)
    if precision:
        body[..., 2 + wi] = ord(".")
        _put_digits(body[..., 3 + wi:], None, frac)
    block[:, -1] = ord("\n")
    data = block[mask]
    if rows.size == n:
        return [data]
    ends = np.concatenate([[0], np.cumsum(mask.sum(1))])
    pieces, at = [], 0
    for i in np.flatnonzero(~ok):
        b = int(np.searchsorted(rows, i))  # block rows ahead of row i
        pieces += [data[ends[at]:ends[b]], _python_line(labels[i], emb[i], precision)]
        at = b
    return pieces + [data[ends[at]:]]


def write_emb(
    path: str,
    embeddings: np.ndarray,
    labels: Optional[Sequence] = None,
    precision: int = 6,
) -> None:
    emb = np.asarray(embeddings)
    n, d = emb.shape
    labs = [str(i).encode() for i in range(n)] if labels is None else [
        str(lab).encode() for lab in labels]
    pieces = _emb_text(emb, labs, precision)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"{n} {d}\n".encode())
        for piece in pieces:
            f.write(piece)


def read_emb(path: str) -> Tuple[List[str], np.ndarray]:
    """Return (labels, float32[N, D]) preserving file order."""
    with open(path, "r") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        labels: List[str] = []
        vecs = np.empty((n, d), dtype=np.float32)
        for i in range(n):
            toks = f.readline().rstrip("\n").split(" ")
            labels.append(toks[0])
            vecs[i] = np.array(toks[1 : d + 1], dtype=np.float32)
    return labels, vecs


def read_emb_dict(path: str) -> Dict[str, np.ndarray]:
    labels, vecs = read_emb(path)
    return {lab: vecs[i] for i, lab in enumerate(labels)}
