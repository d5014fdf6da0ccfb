"""CSR graph containers on torch tensors (counterpart of ``graphtpu/core/graph.py``).

A graph is a flat CSR: ``row_ptr[V+1]`` / ``col[E]`` / optional
``weight[E]`` / ``deg[V]``, with neighbours sorted within each row (the
reference walker iterates ``sorted(G.neighbors(cur))``).  Construction
happens on the host in numpy; the tensors live on whatever device the
caller names, and every graph keeps the host numpy arrays it was built
from so plan builders (:mod:`graphtpu_torch.kernels.spmm`,
:mod:`graphtpu_torch.core.reorder`) never read the device back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

HostCSR = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected (or single-direction) graph in CSR form.

    ``row_ptr``: int32[V+1] (int64 past 2^31 slots); ``col``: int32[E]
    sorted within each row; ``weight``: float32[E] or None; ``deg``:
    int32[V].  ``host`` is the numpy mirror of the same four arrays.
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    weight: Optional[torch.Tensor]
    deg: torch.Tensor
    max_degree: int
    host: HostCSR = dataclasses.field(repr=False, compare=False)

    @property
    def n_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        """Directed edge slots in CSR (an undirected edge occupies two)."""
        return self.col.shape[0]

    @property
    def is_weighted(self) -> bool:
        return self.weight is not None

    @property
    def device(self) -> torch.device:
        return self.col.device

    def to(self, device) -> "Graph":
        """The same graph with its tensors on ``device``."""
        return dataclasses.replace(
            self,
            row_ptr=self.row_ptr.to(device),
            col=self.col.to(device),
            weight=None if self.weight is None else self.weight.to(device),
            deg=self.deg.to(device),
        )


@dataclasses.dataclass(frozen=True)
class DiGraph:
    """Directed graph: separate out-CSR and in-CSR."""

    out: Graph
    in_: Graph


def _build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    wts: Optional[np.ndarray],
    n_nodes: int,
) -> HostCSR:
    """Sort edges by (src, dst) and emit CSR arrays (numpy, host)."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if wts is not None:
        wts = wts[order]
    deg = np.bincount(src, minlength=n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    if row_ptr[-1] <= np.iinfo(np.int32).max:
        row_ptr = row_ptr.astype(np.int32)
    return row_ptr, dst.astype(np.int32), wts, deg


def graph_from_numpy(row_ptr, col, weight, deg, device="cpu") -> Graph:
    """A :class:`Graph` from host CSR arrays (those of ``host_csr``), with
    tensors on ``device``."""
    host = tuple(None if a is None else np.asarray(a) for a in (row_ptr, col, weight, deg))

    def t(a):
        return None if a is None else torch.tensor(a, device=device)

    return Graph(
        row_ptr=t(host[0]),
        col=t(host[1]),
        weight=t(host[2]),
        deg=t(host[3]),
        max_degree=int(np.max(host[3], initial=0)),
        host=host,
    )


def host_csr(g: Graph) -> HostCSR:
    """(row_ptr, col, weight, deg) as numpy, from the construction mirror."""
    return g.host


def build_graph(
    edges: np.ndarray,
    weights: Optional[np.ndarray] = None,
    n_nodes: Optional[int] = None,
    directed: bool = False,
    dedup: bool = True,
    device="cpu",
):
    """Build a :class:`Graph` (undirected) or :class:`DiGraph` (directed).

    ``edges``: int array [E, 2].  Undirected edges are mirrored into both
    rows.  ``dedup=True`` collapses duplicate (src, dst) pairs, keeping the
    last weight; ``dedup=False`` keeps multi-edges.
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    src = edges[:, 0].astype(np.int64)
    dst = edges[:, 1].astype(np.int64)
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)

    def dedup_pairs(s, d, w):
        key = s * n_nodes + d
        uniq = np.unique(key)
        s2, d2 = uniq // n_nodes, uniq % n_nodes
        w2 = None
        if w is not None:
            # keep the *last* weight for duplicates (networkx overwrite)
            lastw = np.empty(len(uniq), dtype=np.float32)
            lastw[np.searchsorted(uniq, key)] = w
            w2 = lastw
        return s2, d2, w2

    if directed:
        if dedup:
            src, dst, weights = dedup_pairs(src, dst, weights)
        out = graph_from_numpy(*_build_csr(src, dst, weights, n_nodes), device=device)
        in_ = graph_from_numpy(*_build_csr(dst, src, weights, n_nodes), device=device)
        return DiGraph(out=out, in_=in_)

    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = None if weights is None else np.concatenate([weights, weights])
    if dedup:
        s2, d2, w2 = dedup_pairs(s2, d2, w2)
    return graph_from_numpy(*_build_csr(s2, d2, w2, n_nodes), device=device)


def read_edgelist_graph(
    path: str,
    delimiter: Optional[str] = None,
    weighted: bool = False,
    directed: bool = False,
    n_nodes: Optional[int] = None,
    dedup: bool = True,
    device="cpu",
):
    """Read a ``src dst [weight]`` edge-list file into a Graph/DiGraph
    (weights dropped unless ``weighted``)."""
    from graphtpu_torch.io.edgelist import read_edgelist

    edges, wts = read_edgelist(path, delimiter=delimiter)
    if not weighted:
        wts = None
    return build_graph(
        edges, wts, n_nodes=n_nodes, directed=directed, dedup=dedup,
        device=device,
    )


def pad_graph_nodes(g: Graph, n_nodes: int) -> Graph:
    """Extend ``g`` with isolated (degree-0) pad nodes up to ``n_nodes``."""
    v = g.n_nodes
    if n_nodes < v:
        raise ValueError(f"cannot pad {v} nodes down to {n_nodes}")
    if n_nodes == v:
        return g
    rp, col, wts, deg = g.host
    rp2 = np.concatenate([rp, np.full(n_nodes - v, rp[-1], rp.dtype)])
    deg2 = np.concatenate([deg, np.zeros(n_nodes - v, np.int32)])
    return graph_from_numpy(rp2, col, wts, deg2, device=g.device)


def padded_neighbors(
    g: Graph, pad_to: Optional[int] = None, fill: int = -1
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[V, Dmax] padded neighbour (and weight) matrices on the graph's device.

    Rows keep CSR (sorted) order; unused slots get ``fill``.  Built in numpy
    from the host arrays.  O(V*Dmax) memory: the exact second-order step's
    operand, for small graphs.
    """
    dmax = int(pad_to if pad_to is not None else max(g.max_degree, 1))
    rp, col, w, deg = g.host
    v = g.n_nodes
    src = np.repeat(np.arange(v), deg)
    pos = np.arange(len(src)) - np.repeat(rp[:-1].astype(np.int64), deg)
    nbrs = np.full((v, dmax), fill, dtype=np.int32)
    nbrs[src, pos] = col[: len(src)]
    wts = None
    if w is not None:
        wts = np.zeros((v, dmax), dtype=np.float32)
        wts[src, pos] = w[: len(src)]
    return (
        torch.from_numpy(nbrs).to(g.device),
        None if wts is None else torch.from_numpy(wts).to(g.device),
    )


def dense_adjacency(g: Graph, dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense [V, V] (weighted) adjacency, built on the host with float32
    adds in CSR order, then moved to ``device`` (default: the graph's)."""
    rp, col, w, deg = g.host
    v = g.n_nodes
    a = np.zeros((v, v), dtype=np.float32)
    if w is None:
        w = np.ones(len(col), np.float32)
    src = np.repeat(np.arange(v), deg)
    np.add.at(a, (src, col[: len(src)]), w[: len(src)])
    return torch.as_tensor(a, device=device or g.device).to(dtype)


def row_normalized(a: torch.Tensor) -> torch.Tensor:
    """P with P[i, u] = a[i, u] / sum_u a[i, u]; zero rows stay zero."""
    rowsum = a.sum(dim=1, keepdim=True)
    safe = torch.where(rowsum > 0, rowsum, torch.ones_like(rowsum))
    return torch.where(rowsum > 0, a / safe, torch.zeros_like(a))
