"""O(1) edge-membership probes (counterpart of ``graphtpu/kernels/edgeset.py``):
the node2vec bias's ``edge(prev, x)`` predicate
(``node2vec/src/node2vec.py:73``).

Built on the host from the graph's numpy arrays with graphtpu's own code,
so the tables are bit-equal to graphtpu's, then probed where the set lies:

* ``bitmap`` (small V): a V*V bit matrix packed into 32-bit words, held as
  int32 (the same bits).  One gather and one bit test per probe; exact.
  Used when the bitmap fits the byte budget (64 MB: V <= ~23k).
* ``cuckoo`` (any V): a cuckoo filter with 1-slot buckets at <= 25% load
  and a 32-bit fingerprint from a second hash of (u, v), held as int64
  (the unsigned values).  Two gathers and two compares per probe; a false
  positive needs two independent 32-bit hashes to collide (~E/2^64).

torch has no ``>>`` for uint32 on the CPU, so the probe's hashes run in
int64 on values below 2^32, keeping the low 32 bits after every multiply
and add; they are bit-equal to the numpy forms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph

_BITMAP_BYTE_BUDGET = 64 * 1024 * 1024
_M32 = 0xFFFFFFFF


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """32-bit finalizer (murmur3-style avalanche), numpy uint32."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _fingerprint_np(u: np.ndarray, v: np.ndarray):
    """(slot-hash, fingerprint) of pairs: two independent 32-bit hashes."""
    u = u.astype(np.uint32)
    v = v.astype(np.uint32)
    h = _mix32_np(u * np.uint32(2654435761) + v)
    fp = _mix32_np(v * np.uint32(0x85EBCA6B) + u) | np.uint32(1)
    return h, fp


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves so
    no product passes 2^48."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32_np` on int64 tensors holding uint32 values."""
    x = x.long() & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _fingerprint(u: torch.Tensor, v: torch.Tensor):
    """:func:`_fingerprint_np` on int64 tensors (ids taken mod 2^32)."""
    u = u.long() & _M32
    v = v.long() & _M32
    h = _mix32((_mul32(u, 2654435761) + v) & _M32)
    fp = _mix32((_mul32(v, 0x85EBCA6B) + u) & _M32) | 1
    return h, fp


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """Constant-probe membership structure over a graph's edge set."""

    words: Optional[torch.Tensor]  # bitmap: int32[ceil(V*V/32)], uint32 bits
    table: Optional[torch.Tensor]  # cuckoo: int64[m] fingerprints (0 = empty)
    mode: str
    n_nodes: int
    mask: int  # cuckoo: m - 1

    def to(self, device) -> "EdgeSet":
        return dataclasses.replace(
            self,
            words=None if self.words is None else self.words.to(device),
            table=None if self.table is None else self.table.to(device),
        )


def _build_cuckoo(src: np.ndarray, dst: np.ndarray, m: int) -> Optional[np.ndarray]:
    """Vectorised cuckoo-filter build; returns uint32[m] or None on failure.

    The alternate slot is ``idx ^ mix(fp)`` (partial-key cuckoo), so an
    evicted occupant can be rehomed knowing only its stored fingerprint.
    """
    mask = np.uint32(m - 1)
    tbl = np.zeros(m, np.uint32)
    h, fp = _fingerprint_np(src, dst)
    idx = h & mask
    for _ in range(500):
        if idx.size == 0:
            return tbl
        # one winner per slot; duplicates with equal fp count as placed
        uniq, first = np.unique(idx, return_index=True)
        old = tbl[uniq]
        winner = fp[first]
        tbl[uniq] = winner
        placed = tbl[idx] == fp
        # evicted occupants reinsert at their alternate slot
        ev = (old != 0) & (old != winner)
        ev_fp = old[ev]
        ev_idx = uniq[ev] ^ (_mix32_np(ev_fp) & mask)
        # losers (same slot, different fp) retry at their alternate slot
        lose_fp = fp[~placed]
        lose_idx = idx[~placed] ^ (_mix32_np(lose_fp) & mask)
        fp = np.concatenate([ev_fp, lose_fp])
        idx = np.concatenate([ev_idx, lose_idx])
    return None


def build_edge_set(g: Graph, bitmap_byte_budget: int = _BITMAP_BYTE_BUDGET) -> EdgeSet:
    """Host build from the graph's numpy arrays, on the CPU (``EdgeSet.to``
    moves it)."""
    _, col, _, deg = g.host
    v = g.n_nodes
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    dst = col.astype(np.int64)
    if v * v // 8 <= bitmap_byte_budget:
        bits = src * v + dst
        words = np.zeros((v * v + 31) // 32, np.uint32)
        np.bitwise_or.at(
            words, (bits >> 5).astype(np.int64),
            np.uint32(1) << (bits & 31).astype(np.uint32),
        )
        return EdgeSet(
            words=torch.from_numpy(words.view(np.int32)), table=None,
            mode="bitmap", n_nodes=v, mask=0,
        )
    m = 1 << max(4, int(np.ceil(np.log2(max(1, 4 * len(dst))))))
    for _ in range(4):
        tbl = _build_cuckoo(src, dst, m)
        if tbl is not None:
            return EdgeSet(
                words=None, table=torch.from_numpy(tbl.astype(np.int64)),
                mode="cuckoo", n_nodes=v, mask=m - 1,
            )
        m *= 2
    raise RuntimeError("cuckoo edge-set build failed to converge")


def edge_set_contains(es: EdgeSet, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bool per pair (broadcasting): is (u, v) an edge?  Invalid ids (< 0)
    are never members.  Runs where the set lies."""
    u, v = torch.broadcast_tensors(u, v)
    valid = (u >= 0) & (v >= 0)
    us = u.clamp(min=0)
    vs = v.clamp(min=0)
    if es.mode == "bitmap":
        # int32 is exact: the budget caps V*V below 2^31
        bits = us.int() * es.n_nodes + vs.int()
        word = es.words[(bits >> 5).long()]
        # an arithmetic shift of a negative word still leaves bit k at 0
        return (((word >> (bits & 31)) & 1) != 0) & valid
    h, fp = _fingerprint(us, vs)
    i1 = h & es.mask
    i2 = i1 ^ (_mix32(fp) & es.mask)
    return ((es.table[i1] == fp) | (es.table[i2] == fp)) & valid


# Per-graph caches, keyed by the graph's host ``col`` array: every copy of a
# graph on any device shares it (``Graph.to`` keeps ``host``).  An entry
# holds the array weakly: a graph that is gone takes its id's entry with it
# (its tables are dropped before the next build), so a process that reads
# one graph after another, as a run of CLI jobs does, holds one graph's.
_CACHE: dict = {}


def _cached(key, col: np.ndarray, build):
    import weakref

    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is col:
        return hit[1]
    for k in [k for k, (ref, _) in _CACHE.items() if ref() is None]:
        del _CACHE[k]
    if len(_CACHE) > 16:
        _CACHE.clear()
    es = build()
    _CACHE[key] = (weakref.ref(col), es)
    return es


def edge_set(g: Graph) -> EdgeSet:
    """The graph's edge set on the host, built once per graph."""
    col = g.host[1]
    return _cached(("host", id(col), g.n_nodes), col, lambda: build_edge_set(g))


def device_edge_set(g: Graph, device=None) -> EdgeSet:
    """The cached edge set with its tables on ``device`` (default: the
    graph's), so they are copied once per graph and device, not per call."""
    dev = torch.device(device if device is not None else g.device)
    col = g.host[1]
    return _cached(("dev", id(col), g.n_nodes, str(dev)), col, lambda: edge_set(g).to(dev))
