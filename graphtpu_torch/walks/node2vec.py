"""Second-order (p, q)-biased node2vec walks, batched (counterpart of
``graphtpu/walks/node2vec.py``).

The reference keeps an alias table per directed edge
(``node2vec/src/node2vec.py:83-113``); here no per-edge table exists.  The
bias rule (``node2vec.py:61-81``):

  w'(x) = w(cur,x)/p  if x == prev
        = w(cur,x)    if edge(x, prev)
        = w(cur,x)/q  otherwise

* ``rejection`` (default, any degree): propose x ~ w(cur, ·), accept with
  probability bias(x)/max(1/p, 1, 1/q).  A hop draws a [B, chunk] panel of
  proposals (:func:`propose`), probes edge(prev, x) in the edge set
  (:func:`graphtpu_torch.kernels.edgeset.edge_set_contains`) and keeps the
  first accepted proposal (:func:`accept`).  Panels of T <= 10 trials run
  in one round; wider ones (T = 24 at p = q = 0.25) in rounds of 8 that
  stop once fewer than 1e-3 of the walkers are still open, a device-to-host
  read per round.  Walkers never accepted keep their last proposal.
* ``exact`` (small graphs, parity tests): the full biased categorical over
  padded neighbour rows, sampled by Gumbel-max.

Every call adds to :data:`NODE2VEC_COUNTS` (read as differences): the
walks, their hops (every walker each step, dead ones too), the proposals
drawn (one a walker on the first-order hop and on an exact hop; a panel
of ``chunk`` a walker each rejection round) and the rounds that read back
to the host to decide whether to go on.  All are known on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphtpu_torch.core.device import resolve_device
from graphtpu_torch.core.graph import Graph, padded_neighbors
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.edgeset import EdgeSet, device_edge_set, edge_set_contains
from graphtpu_torch.kernels.sampling import (
    row_spans,
    row_cumulative_weights,
    uniform_neighbor,
    weighted_neighbor,
)
from graphtpu_torch.walks.walker import sorted_hop

RESIDUAL = 1e-3

NODE2VEC_COUNTS = {"walks": 0, "hops": 0, "proposals": 0, "host_reads": 0}


def default_max_trials(p: float, q: float, residual: float = RESIDUAL) -> int:
    """Panel width so the worst-case fallback mass (every neighbour in the
    lowest-bias class, acceptance a = min(1/p,1,1/q)/max(1/p,1,1/q)) is
    below ``residual``: (1-a)^T <= residual."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    a = min(inv_p, 1.0, inv_q) / max(inv_p, 1.0, inv_q)
    if a >= 1.0:
        return 1
    return int(min(24, max(2, math.ceil(math.log(residual) / math.log(1 - a)))))


def propose(g: Graph, cumw, cur: torch.Tensor, rows, chunk: int, gen, weighted: bool):
    """int32 [B, chunk] proposals x ~ w(cur, ·); -1 for dead walkers.
    ``rows``: cur's (safe, degree, row start), gathered once per hop."""
    b = cur.shape[0]
    if weighted:
        return weighted_neighbor(g, cumw, cur[:, None].expand(b, chunk), gen)
    _, deg, lo = rows
    u = torch.rand((b, chunk), generator=gen, device=cur.device)
    idx = torch.minimum((u * deg[:, None]).int(), (deg - 1).clamp(min=0)[:, None])
    props = g.col[lo[:, None] + idx]
    alive = (cur >= 0) & (deg > 0)
    return torch.where(alive[:, None], props, -1)


def accept(props, prev, is_tri, inv_p: float, inv_q: float, gen):
    """The panel arithmetic: (any accepted [B], candidate [B]) — the first
    accepted proposal, else the panel's last."""
    qmax = max(inv_p, 1.0, inv_q)
    is_ret = props == prev[:, None]
    bias = torch.where(is_ret, inv_p, torch.where(is_tri, 1.0, inv_q))
    acc = torch.rand(props.shape, generator=gen, device=props.device) < bias / qmax
    acc = acc | (props < 0)  # dead walkers: nothing to retry
    any_acc = acc.any(dim=1)
    first = torch.argmax(acc.to(torch.uint8), dim=1)  # the first maximum
    pick = torch.where(any_acc, first, props.shape[1] - 1)
    return any_acc, torch.gather(props, 1, pick[:, None])[:, 0]


def _second_order_step_rejection(
    g: Graph,
    cumw,
    eset: EdgeSet,
    prev: torch.Tensor,
    cur: torch.Tensor,
    key: int,
    inv_p: float,
    inv_q: float,
    max_trials: int,
    weighted: bool,
) -> torch.Tensor:
    t = max_trials
    chunk = t if t <= 10 else 8
    n_chunks = -(-t // chunk)
    rows = None if weighted else row_spans(g, cur)
    nxt = torch.full_like(cur, -1)
    done = torch.zeros_like(cur, dtype=torch.bool)
    for i in range(n_chunks):
        if i > 0:
            NODE2VEC_COUNTS["host_reads"] += 1
            if (~done).float().mean().item() <= RESIDUAL:
                break
        NODE2VEC_COUNTS["proposals"] += cur.shape[0] * chunk
        gen = generator(key_for(key, i), cur.device)
        props = propose(g, cumw, cur, rows, chunk, gen, weighted)
        is_tri = edge_set_contains(eset, prev[:, None], props)
        any_acc, cand = accept(props, prev, is_tri, inv_p, inv_q, gen)
        nxt = torch.where(done, nxt, cand)
        done = done | any_acc
    return nxt


def _second_order_step_exact(
    g: Graph,
    eset: EdgeSet,
    nbrs: torch.Tensor,
    nwts,
    prev: torch.Tensor,
    cur: torch.Tensor,
    key: int,
    inv_p: float,
    inv_q: float,
) -> torch.Tensor:
    safe = cur.clamp(min=0).long()
    row = nbrs[safe]  # [B, D]
    valid = row >= 0
    is_ret = row == prev[:, None]
    is_tri = edge_set_contains(eset, prev[:, None], row)
    bias = torch.where(is_ret, inv_p, torch.where(is_tri, 1.0, inv_q))
    if nwts is not None:
        bias = bias * nwts[safe]
    logits = torch.where(valid, torch.log(bias), -math.inf)
    u = torch.rand(row.shape, generator=generator(key, cur.device), device=cur.device)
    gum = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(logits + gum, dim=1)
    NODE2VEC_COUNTS["proposals"] += cur.shape[0]
    nxt = torch.gather(row, 1, choice[:, None])[:, 0]
    alive = (cur >= 0) & (g.deg[safe] > 0)
    return torch.where(alive, nxt, -1)


def node2vec_walks(
    g: Graph,
    starts: torch.Tensor,
    num_steps: int,
    p: float,
    q: float,
    key: int,
    weighted: bool = False,
    mode: str = "rejection",
    max_trials: int | None = None,
    eset: EdgeSet | None = None,
    sort_gather: bool = False,
    device=None,
) -> torch.Tensor:
    """int32 [B, num_steps+1] on ``device`` (default ``cuda``); the first
    hop is first-order (alias_nodes semantics, ``node2vec.py:28-29``), later
    hops second-order.

    ``max_trials=None`` sizes the proposal panel from (p, q) via
    :func:`default_max_trials`.  ``eset`` (on ``device``) defaults to the
    graph's cached device edge set.  ``sort_gather``: see
    :func:`graphtpu_torch.walks.walker.sorted_hop`.
    """
    dev = resolve_device(device)
    g = g.to(dev)
    starts = starts.to(device=dev, dtype=torch.int32)
    inv_p, inv_q = 1.0 / p, 1.0 / q
    if max_trials is None:
        max_trials = default_max_trials(p, q)
    if eset is None:
        eset = device_edge_set(g)
    cumw = row_cumulative_weights(g) if weighted else None
    nbrs, nwts = padded_neighbors(g) if mode == "exact" else (None, None)

    NODE2VEC_COUNTS["walks"] += starts.shape[0]
    if num_steps == 0:
        return starts[:, None]
    NODE2VEC_COUNTS["hops"] += starts.shape[0] * num_steps
    NODE2VEC_COUNTS["proposals"] += starts.shape[0]
    gen0 = generator(key_for(key, 0), dev)
    if weighted:
        c1 = weighted_neighbor(g, cumw, starts, gen0)
    else:
        c1 = uniform_neighbor(g, starts, gen0)
    k_rest = key_for(key, 1)

    def hop(cur, prev, k):
        if mode == "exact":
            return _second_order_step_exact(g, eset, nbrs, nwts, prev, cur, k, inv_p, inv_q)
        return _second_order_step_rejection(
            g, cumw, eset, prev, cur, k, inv_p, inv_q, max_trials, weighted
        )

    cols = [starts, c1]
    prev, cur = starts, c1
    for t in range(num_steps - 1):
        k = key_for(k_rest, t)
        if sort_gather:
            nxt = sorted_hop(lambda c, pv: hop(c, pv, k), cur, prev)
        else:
            nxt = hop(cur, prev, k)
        nxt = torch.where(cur < 0, -1, nxt)
        cols.append(nxt)
        prev, cur = cur, nxt
    return torch.stack(cols, dim=1)


def node2vec_transition_probs(g: Graph, prev: int, cur: int, p: float, q: float) -> np.ndarray:
    """Host-side exact next-hop distribution over node ids (dense [V]):
    the reference's ``get_alias_edge`` rule (``node2vec.py:61-81``), the
    oracle of the statistical walk tests."""
    row_ptr, col, w, _ = g.host
    if w is None:
        w = np.ones_like(col, np.float32)
    lo, hi = row_ptr[cur], row_ptr[cur + 1]
    probs = np.zeros(g.n_nodes, np.float64)
    prev_nbrs = set(col[row_ptr[prev] : row_ptr[prev + 1]].tolist())
    for e in range(lo, hi):
        x = int(col[e])
        if x == prev:
            b = w[e] / p
        elif x in prev_nbrs:  # undirected: edge(x, prev) == edge(prev, x)
            b = w[e]
        else:
            b = w[e] / q
        probs[x] += b
    s = probs.sum()
    return probs / s if s > 0 else probs
