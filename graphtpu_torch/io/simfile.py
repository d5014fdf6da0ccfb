"""``.sim.txt`` top-k similarity files — exact reference format.

Writer semantics follow ``utils/Print.java``:
  * ``printByOrder`` / ``printByOrderAll`` emit TWO files per result
    (``Print.java:25-84``): a ``.txt`` with ids only
    (``v,n1,n2,...``) and a ``.sim.txt`` with scores
    (``v,n1:score1,n2:score2,...``), separator ``,`` and k/v separator ``:``
    (``conf/MyConfiguration.java:16-18``), scores ``%.6f`` (top-k) or
    ``%.7f`` (top-1000 "all" variant), sorted descending by score.
  * Lines end with CRLF in the reference; we write plain LF and accept both.

The writers build each file's bytes as one uint8 array with whole-array
numpy passes (``_topk_text``): a float32 score times 10**p is exact in
float64, so ``rint`` of it gives the digits of ``f"{x:.{p}f}"``, ties to
even as Python rounds them.  Rows that cannot be proven so go through the
per-entry loop and keep its bytes (``WRITE_ROWS`` counts both).

Readers accept both the "," separator and the older space-separated files
(e.g. ``IsoMap_LE/data/0_333_5038_simrank_navie_top10.txt.sim.txt:1``,
parsed by ``IsoMap_LE/simRank.py:76-93``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_sim_file(path: str) -> Dict[int, List[Tuple[int, float]]]:
    """Parse a ``.sim.txt`` file into {source: [(neighbor, score), ...]}.

    Order of neighbours is preserved (descending score as written).
    """
    out: Dict[int, List[Tuple[int, float]]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sep = "," if "," in line else None
            toks = line.split(sep) if sep else line.split()
            src = int(toks[0])
            pairs: List[Tuple[int, float]] = []
            for tok in toks[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":")
                pairs.append((int(k), float(v)))
            out[src] = pairs
    return out


def read_topk_ids(path: str) -> Dict[int, List[int]]:
    """Parse the ids-only ``.txt`` companion file (``v,n1,n2,...``)."""
    out: Dict[int, List[int]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sep = "," if "," in line else None
            toks = line.split(sep) if sep else line.split()
            out[int(toks[0])] = [int(t) for t in toks[1:]]
    return out


# rows the writers formatted, by path (once a row, however many files):
# ``array`` by whole-array numpy passes, ``python`` by the per-entry loop,
# which takes the rows whose text the array passes cannot prove exact
WRITE_ROWS = {"array": 0, "python": 0}

# A float32 score times 10**p is exact in float64 up to p = 12: 24 bits of
# mantissa and ceil(12 * log2 5) = 28 bits of 5**12 make 52 bits.
_MAX_PRECISION = 12


def _narrow(v: np.ndarray) -> np.ndarray:
    """``v`` (>= 0) as int32 where it fits: numpy divides int32 faster."""
    return v.astype(np.int32) if v.size == 0 or v.max() < 2 ** 31 else v


def _width(v: np.ndarray) -> int:
    return len(str(int(v.max()))) if v.size else 1


def _put_digits(dst: np.ndarray, dst_mask: Optional[np.ndarray], v: np.ndarray) -> None:
    """Write ``v`` (>= 0, of at most ``w`` digits) into ``dst`` ``[..., w]``
    as zero-padded ASCII digits, one column a digit; where ``dst_mask`` is
    given, clear it over the leading zeros (the last digit stays)."""
    w = dst.shape[-1]
    if dst_mask is not None:
        for i in range(1, w):
            dst_mask[..., w - 1 - i] = v >= 10 ** i
    for i in range(w - 1, 0, -1):
        q = v // 10
        np.add(v - q * 10, 48, out=dst[..., i], casting="unsafe")
        v = q
    if w:
        np.add(v, 48, out=dst[..., 0], casting="unsafe")


def _lines(head: np.ndarray, entry, keep: np.ndarray):
    """One line a row: the ``head`` number, then each kept entry's fields
    in order, then a newline.  A field is constant bytes or (numbers
    ``[rows, k]``, width, right-aligned without leading zeros or not).
    Returns the text as a uint8 array and the ``[rows, width]`` mask that
    selected it from the block."""
    n, k = keep.shape
    wh, we = _width(head), sum(len(f) if isinstance(f, bytes) else f[1] for f in entry)
    block = np.empty((n, wh + k * we + 1), np.uint8)
    mask = np.ones(block.shape, bool)
    _put_digits(block[:, :wh], mask[:, :wh], head)
    body = block[:, wh:wh + k * we].reshape(n, k, we)
    body_mask = mask[:, wh:wh + k * we].reshape(n, k, we)
    at = 0
    for f in entry:
        if isinstance(f, bytes):
            body[..., at:at + len(f)] = np.frombuffer(f, np.uint8)
            at += len(f)
        else:
            v, w, trim = f
            _put_digits(body[..., at:at + w], body_mask[..., at:at + w] if trim else None, v)
            at += w
    if not keep.all():
        body_mask[~keep] = False
    block[:, -1] = ord("\n")
    return block[mask], mask


def _python_lines(rows, indices, scores, srcs, precision, separator, kv_separator,
                  min_score):
    """The per-entry loop: the lines of ``rows`` as (ids, sim) strings."""
    ids, sims = [], []
    for i in rows:
        idparts = [str(int(srcs[i]))]
        simparts = [str(int(srcs[i]))]
        for j in range(indices.shape[1]):
            idx = int(indices[i, j])
            if idx < 0:
                continue
            idparts.append(str(idx))
            sc = float(scores[i, j])
            if min_score is not None and sc < min_score:
                continue
            simparts.append(f"{idx}{kv_separator}{sc:.{precision}f}")
        ids.append(separator.join(idparts) + "\n")
        sims.append(separator.join(simparts) + "\n")
    return ids, sims


def _topk_text(indices, scores, sources, precision, separator, kv_separator, min_score,
               with_ids):
    """The bytes of the ``.sim.txt`` (and, ``with_ids``, of the ids file) as
    lists of buffers in order.  Rows go through whole-array passes where
    every kept entry's text is provably the loop's: integer ids and
    sources >= 0, scores exact in float32, finite, not negative (nor -0.0)
    and below 2**53 once scaled by 10**precision; the loop takes the rest."""
    indices, scores = np.asarray(indices), np.asarray(scores)
    n = indices.shape[0]
    srcs = np.arange(n) if sources is None else np.asarray(sources)[:n]
    arrays = (indices.ndim == 2 and scores.shape == indices.shape and srcs.shape == (n,)
              and np.can_cast(indices.dtype, np.int64) and np.can_cast(srcs.dtype, np.int64)
              and np.can_cast(scores.dtype, np.float32)
              and isinstance(precision, (int, np.integer)) and not isinstance(precision, bool)
              and 0 <= precision <= _MAX_PRECISION)
    ok = np.zeros(n, bool)
    if arrays:
        idx = indices.astype(np.int64, copy=False)
        src = srcs.astype(np.int64, copy=False)
        sc = scores.astype(np.float64)
        keep = idx >= 0
        if min_score is not None:
            keep &= ~(sc < min_score)
        scaled = np.rint(sc * 10.0 ** precision)
        exact = np.isfinite(scaled) & ~np.signbit(scaled) & (scaled < 2.0 ** 53)
        ok = (src >= 0) & ~(keep & ~exact).any(1)
    py_rows = np.flatnonzero(~ok)
    WRITE_ROWS["array"] += n - py_rows.size
    WRITE_ROWS["python"] += py_rows.size
    if py_rows.size == n:
        ids, sims = _python_lines(range(n), indices, scores, srcs, precision, separator,
                                  kv_separator, min_score)
        return ([s.encode() for s in ids] if with_ids else None), [s.encode() for s in sims]
    if py_rows.size:
        idx, src, keep, scaled = idx[ok], src[ok], keep[ok], scaled[ok]
    # the ids file keeps every entry of index >= 0, ``min_score`` aside
    id_keep = idx >= 0
    ids = _narrow(np.where(id_keep, idx, 0))
    q, unit = np.where(keep, scaled, 0).astype(np.int64), 10 ** precision
    q = _narrow(q) if unit < 2 ** 31 else q
    quot = q // unit
    frac = q - quot * unit
    sep, src = separator.encode(), _narrow(src)
    id_field = (ids, _width(ids), True)
    score = [(quot, _width(quot), True)]
    if precision:
        score += [b".", (frac, precision, False)]
    texts = [_lines(src, [sep, id_field, kv_separator.encode(), *score], keep)]
    if with_ids:
        texts.append(_lines(src, [sep, id_field], id_keep))
    if not py_rows.size:
        out = [[t[0]] for t in texts]
    else:
        ids, sims = _python_lines(py_rows, indices, scores, srcs, precision, separator,
                                  kv_separator, min_score)
        before = np.searchsorted(np.flatnonzero(ok), py_rows)  # array rows ahead of each
        out = []
        for (data, mask), lines in zip(texts, (sims, ids)):
            ends = np.concatenate([[0], np.cumsum(mask.sum(1))])
            pieces, at = [], 0
            for b, line in zip(before, lines):
                pieces += [data[ends[at]:ends[b]], line.encode()]
                at = b
            out.append(pieces + [data[ends[at]:]])
    return (out[1] if with_ids else None), out[0]


def _write(path: str, pieces) -> None:
    with open(path, "wb") as f:
        for piece in pieces:
            f.write(piece)


def write_sim_file(
    path: str,
    indices: np.ndarray,
    scores: np.ndarray,
    sources: Optional[np.ndarray] = None,
    precision: int = 6,
    separator: str = ",",
    kv_separator: str = ":",
    min_score: Optional[float] = None,
) -> None:
    """Write ``.sim.txt`` lines from dense [N, K] top-k (indices, scores).

    Entries with index < 0 are skipped (padding); ``min_score`` drops
    entries below a floor (callers usually pass None and pre-filter).
    """
    _, sim = _topk_text(indices, scores, sources, precision, separator, kv_separator,
                        min_score, with_ids=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write(path, sim)


def write_topk_files(
    out_path: str,
    indices: np.ndarray,
    scores: np.ndarray,
    sources: Optional[np.ndarray] = None,
    precision: int = 6,
    separator: str = ",",
) -> Tuple[str, str]:
    """Reference `Print.printByOrder` twin output: ``out_path`` (ids only)
    plus ``out_path + ".sim.txt"`` (ids:scores).  Returns both paths."""
    ids, sim = _topk_text(indices, scores, sources, precision, separator, ":", None,
                          with_ids=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    sim_path = out_path + ".sim.txt"
    _write(out_path, ids)
    _write(sim_path, sim)
    return out_path, sim_path
