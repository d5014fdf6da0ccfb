"""Partitioned CSR: the graph no longer fits one worker (counterpart of
``graphtpu/dist/sharded_graph.py``).

The reference's defining distributed property is a graph larger than any
single machine: Giraph partitions vertices over workers and every vertex's
adjacency list lives only on its owner
(``giraph/CombineBatchSingleWalkVertexReuse.java:39-48`` runs 10M vertices
over 14 workers).  Ownership is by contiguous node range, so it is a
division: rank ``d`` owns nodes ``[d*nodes_per, (d+1)*nodes_per)`` and
holds only their CSR rows.

A rank's block, laid out as one row of graphtpu's stacked arrays:

  * ``row_ptr  [nodes_per+1]``: rebased (``row_ptr[0] == 0``);
  * ``col      [e_cap]``: global target ids, -1 padded;
  * ``weight   [e_cap]``: optional;
  * ``deg      [nodes_per]``;
  * ``deg_global [n_dev*nodes_per]``: every node's degree, replicated
    (O(V) ints: the SimRank increment needs ``deg(path[i]) / deg(path[2i])``
    of remote nodes, ``SingleRandomWalk.java:53-106``).

``e_cap`` is the largest shard's edge count rounded up to 128, so a rank
holds O(E/n_dev + slack) edge slots.  :func:`local_graph` turns the block
into a plain :class:`Graph` over the rank's rows, so the single-device
samplers run against the shard with node ids rebased by
``- rank*nodes_per``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph, host_csr
from graphtpu_torch.kernels.sampling import row_cumulative_weights


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """One rank's block of a CSR partitioned by contiguous node range."""

    row_ptr: torch.Tensor            # [nodes_per + 1], rebased
    col: torch.Tensor                # [e_cap], global ids, -1 pad
    weight: Optional[torch.Tensor]   # [e_cap] or None
    deg: torch.Tensor                # [nodes_per]
    deg_global: torch.Tensor         # [n_dev * nodes_per], replicated
    n_nodes: int                     # true (unpadded) node count
    nodes_per: int                   # nodes owned per rank
    max_degree: int                  # of the whole graph
    n_dev: int
    rank: int                        # whose block this is

    @property
    def e_cap(self) -> int:
        return self.col.shape[0]

    @property
    def device(self) -> torch.device:
        return self.col.device


def shard_arrays(g: Graph, n_dev: int) -> Dict[str, Optional[np.ndarray]]:
    """graphtpu's stacked shard arrays, on the host: ``row_ptr [n_dev,
    nodes_per+1]``, ``col``/``weight [n_dev, e_cap]``, ``deg [n_dev,
    nodes_per]`` and ``deg_global [n_dev*nodes_per]``."""
    v = g.n_nodes
    nodes_per = -(-v // n_dev)
    rp_h, col, wts, deg = host_csr(g)
    row_ptr = np.asarray(rp_h).astype(np.int64)
    counts = [int(row_ptr[min((d + 1) * nodes_per, v)] - row_ptr[min(d * nodes_per, v)])
              for d in range(n_dev)]
    e_cap = max(128, -(-max(counts) // 128) * 128)

    rp_s = np.zeros((n_dev, nodes_per + 1), np.int32)
    col_s = np.full((n_dev, e_cap), -1, np.int32)
    w_s = None if wts is None else np.zeros((n_dev, e_cap), np.float32)
    deg_s = np.zeros((n_dev, nodes_per), np.int32)
    for d in range(n_dev):
        lo, hi = d * nodes_per, min((d + 1) * nodes_per, v)
        if lo >= v:
            continue
        e_lo, e_hi = int(row_ptr[lo]), int(row_ptr[hi])
        local = row_ptr[lo: hi + 1] - row_ptr[lo]
        rp_s[d, : hi - lo + 1] = local
        rp_s[d, hi - lo + 1:] = local[-1]
        col_s[d, : e_hi - e_lo] = col[e_lo:e_hi]
        if w_s is not None:
            w_s[d, : e_hi - e_lo] = wts[e_lo:e_hi]
        deg_s[d, : hi - lo] = deg[lo:hi]
    deg_g = np.zeros(nodes_per * n_dev, np.int32)
    deg_g[:v] = deg
    return dict(row_ptr=rp_s, col=col_s, weight=w_s, deg=deg_s, deg_global=deg_g)


def shard_graph(g: Graph, n_dev: int, mesh) -> ShardedGraph:
    """This rank's contiguous-range CSR shard of ``g``, split ``n_dev`` ways
    over the 1-D ``mesh``, on the rank's device (graphtpu's stacked arrays
    are :func:`shard_arrays`)."""
    if mesh.size != n_dev:
        raise ValueError(f"a mesh of {mesh.size} ranks holds {mesh.size} shards, not {n_dev}")
    rank, dev = mesh.coords[0], mesh.device
    arrs = shard_arrays(g, n_dev)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ShardedGraph(
        row_ptr=t(arrs["row_ptr"][rank]),
        col=t(arrs["col"][rank]),
        weight=None if arrs["weight"] is None else t(arrs["weight"][rank]),
        deg=t(arrs["deg"][rank]),
        deg_global=t(arrs["deg_global"]),
        n_nodes=g.n_nodes,
        nodes_per=arrs["deg"].shape[1],
        max_degree=g.max_degree,
        n_dev=n_dev,
        rank=rank,
    )


def local_graph(sg: ShardedGraph) -> Graph:
    """The rank's block as a :class:`Graph` over its ``nodes_per`` rows
    (global column ids, -1 padded; the whole graph's max degree)."""
    host = tuple(None if a is None else a.cpu().numpy()
                 for a in (sg.row_ptr, sg.col, sg.weight, sg.deg))
    return Graph(row_ptr=sg.row_ptr, col=sg.col, weight=sg.weight, deg=sg.deg,
                 max_degree=sg.max_degree, host=host)


def local_cumulative_weights(g_loc: Graph) -> torch.Tensor:
    """float32 [e_cap] within-row cumulative weights of a block's local graph
    (:func:`row_cumulative_weights` over its real edge slots; 0 on the
    padding)."""
    n_e = int(g_loc.host[0][-1])
    real = dataclasses.replace(g_loc, col=g_loc.col[:n_e],
                               weight=None if g_loc.weight is None else g_loc.weight[:n_e])
    out = torch.zeros(g_loc.n_edges, dtype=torch.float32, device=g_loc.device)
    out[:n_e] = row_cumulative_weights(real)
    return out
