"""Plain node2vec walks' bias rule and skip-gram with negative sampling in
PyTorch: the benchmark's reference for the ``node2vec`` CLI job
(``node2vec/src/main.py:92-114`` with gensim's ``Word2Vec``).

(a) The bias rule (``node2vec/src/node2vec.py:61-81``).  From a state
    (prev, cur) of an unweighted undirected graph a walk steps to x, a
    neighbour of cur, with weight 1/p where x = prev, 1 where x is also a
    neighbour of prev, 1/q otherwise.  :func:`hop_shares` gives, for the
    second-order hops of walks it is given, the share of each hop kind
    (back, to a common neighbour, outward) that the rule expects for the
    same states and the share the walks took.  The common-neighbour
    counts are exact: a dense float32 A·A.  :func:`walk_faults` counts the
    hops that are not edges, the walks cut short where the node has
    neighbours, and the nodes that start another number of walks than
    ``num_walks`` (none for an isolated node).
(b) One SGNS step (:func:`sgns_step`) in float64: closed-form gradients of
    log σ(v·u) over the window's pairs and log σ(-v·u_n) over negatives;
    one negative set a center, shared across its window, a negative that
    equals the pair's context or the center skipped for that pair; each
    touched row moves by lr times its summed gradient over the number of
    times the batch holds it (collision normalisation; the counts take
    the valid centers, the window's contexts and every negative).
(c) :func:`train_epochs`: gensim's semantics over those steps: syn0 ~
    U(-0.5/d, 0.5/d), syn1 = 0; a token kept with probability
    (sqrt(f/sample) + 1)·sample/f each epoch, each walk compacted; every
    slot a center once an epoch in random order; a dynamic window b ~
    U{1..window} a center; negatives from the walks' unigram^0.75; the
    rate decaying linearly from alpha to min_alpha over the run.
    :func:`edge_auc` scores embeddings by their dot products on edges
    against non-adjacent pairs.

Departures from gensim, the same as the program's: synchronous minibatch
steps of ``batch`` centers in place of hogwild per-pair SGD over 8
threads, so every center of a batch reads the tables as they were before
the batch; one negative set a center, shared across its window, in place
of a set a pair.  Its draws are its own (``torch.multinomial`` and
``torch.rand`` from a seeded generator): it matches the program in law,
not in bits.  Plain PyTorch with TF32 off; it imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def adjacency(edges: np.ndarray, n_nodes: int, device) -> torch.Tensor:
    """Dense float32 [V, V] 0/1 adjacency: each pair mirrored, duplicates
    collapsed, self-loops dropped."""
    e = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2), device=device)
    e = e[e[:, 0] != e[:, 1]]
    a = torch.zeros((n_nodes, n_nodes), dtype=torch.float32, device=device)
    a[e[:, 0], e[:, 1]] = 1.0
    a[e[:, 1], e[:, 0]] = 1.0
    return a


def walk_faults(walks: torch.Tensor, adj: torch.Tensor, num_walks: int) -> Dict[str, float]:
    """``bad_hops``: consecutive nodes of a walk that are not an edge, a
    walk that ends (-1) after a node with neighbours, or resumes after a
    -1; ``bad_starts``: nodes that start other than ``num_walks`` walks
    (an isolated node none), and walks that start at -1."""
    deg = adj.sum(1)
    w = walks.long()
    a, b = w[:, :-1], w[:, 1:]
    live = (a >= 0) & (b >= 0)
    not_edge = live & (adj[a.clamp(min=0), b.clamp(min=0)] == 0)
    cut = (a >= 0) & (b < 0) & (deg[a.clamp(min=0)] > 0)
    resumed = (a < 0) & (b >= 0)
    start = w[:, 0]
    want = torch.where(deg > 0, num_walks, 0)
    got = torch.bincount(start[start >= 0], minlength=adj.shape[0])
    return {"bad_hops": float((not_edge | cut | resumed).sum()),
            "bad_starts": float((got != want).sum() + (start < 0).sum())}


def hop_shares(walks: torch.Tensor, adj: torch.Tensor, p: float,
               q: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the walks' share of each hop kind, the rule's expected share),
    float64 [3] each (back, common neighbour, outward), over the hops from
    a state (prev, cur) to a live node, in every walk, from its second hop
    on."""
    with _no_tf32():
        common = adj @ adj  # [prev, cur]: the neighbours the two share
    w = walks.long()
    prev, cur, nxt = w[:, :-2].reshape(-1), w[:, 1:-1].reshape(-1), w[:, 2:].reshape(-1)
    keep = (nxt >= 0) & (cur >= 0) & (prev >= 0)
    prev, cur, nxt = prev[keep], cur[keep], nxt[keep]
    back = adj[cur, prev].double()
    cn = common[prev, cur].double()
    out = adj.sum(1)[cur].double() - back - cn
    z = back / p + cn + out / q
    want = torch.stack([(back / p / z).mean(), (cn / z).mean(), (out / q / z).mean()])
    is_back = nxt == prev
    is_common = ~is_back & (adj[prev, nxt] > 0)
    got = torch.stack([is_back.double().mean(), is_common.double().mean(),
                       (~is_back & ~is_common).double().mean()])
    return got, want


def sgns_step(syn0: torch.Tensor, syn1: torch.Tensor, centers: torch.Tensor,
              contexts: torch.Tensor, mask: torch.Tensor, negatives: torch.Tensor,
              lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of (b) in float64: the new (syn0, syn1).  ``centers`` [B]
    (-1: none), ``contexts`` [B, 2w] with ``mask`` (inside the window and
    a live token), ``negatives`` [B, N]."""
    s0, s1 = syn0.double(), syn1.double()
    n_rows = s0.shape[0]
    has = centers >= 0
    c, x, ng = centers.clamp(min=0).long(), contexts.clamp(min=0).long(), negatives.long()
    pair = mask & has[:, None]                                      # [B, 2w]
    v, u, un = s0[c], s1[x], s1[ng]
    g_pos = (torch.sigmoid(torch.einsum("bd,bwd->bw", v, u)) - 1.0) * pair
    hits = (ng[:, None, :] == contexts.long()[..., None]) | (ng == centers.long()[:, None])[:, None]
    coeff = (pair[..., None] & ~hits).sum(1).double()               # [B, N]
    g_neg = torch.sigmoid(torch.einsum("bd,bnd->bn", v, un)) * coeff
    dv = torch.einsum("bw,bwd->bd", g_pos, u) + torch.einsum("bn,bnd->bd", g_neg, un)
    g0 = torch.zeros_like(s0).index_add_(0, c[has], dv[has])
    n0 = torch.bincount(c[has], minlength=n_rows)
    ctx = x[mask]
    rows1 = torch.cat([ctx, ng.reshape(-1)])
    grads1 = torch.cat([(g_pos[..., None] * v[:, None, :])[mask],
                        (g_neg[..., None] * v[:, None, :]).reshape(-1, v.shape[1])])
    g1 = torch.zeros_like(s1).index_add_(0, rows1, grads1)
    n1 = torch.bincount(rows1, minlength=n_rows)
    return (s0 - lr * g0 / n0.clamp(min=1)[:, None],
            s1 - lr * g1 / n1.clamp(min=1)[:, None])


def _compacted(walks: torch.Tensor, keep_p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Each walk's kept tokens first, in order, then -1."""
    live = walks >= 0
    keep = live & (torch.rand(walks.shape, generator=gen, device=walks.device)
                   < keep_p[walks.clamp(min=0)])
    out = torch.full_like(walks, -1)
    dest = torch.cumsum(keep, dim=1) - 1
    rows = torch.arange(walks.shape[0], device=walks.device)[:, None].expand_as(walks)
    out[rows[keep], dest[keep]] = walks[keep]
    return out


def train_epochs(walks: torch.Tensor, n_nodes: int, dim: int, window: int, negative: int,
                 sample: float, alpha: float, min_alpha: float, batch: int, epochs: int,
                 seed: int) -> torch.Tensor:
    """(c) on int [W, L] walks (-1 padded), on their device: float64
    syn0 [V, dim]."""
    dev = walks.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = walks.long()
    counts = torch.bincount(w[w >= 0], minlength=n_nodes).double()
    freq = counts / counts.sum()
    keep_p = ((torch.sqrt(freq / sample) + 1.0) * sample / freq.clamp(min=1e-300)).clamp(max=1.0)
    unigram = counts.pow(0.75)
    syn0 = (torch.rand((n_nodes, dim), generator=gen, device=dev, dtype=torch.float64)
            - 0.5) / dim
    syn1 = torch.zeros_like(syn0)
    n_walks, length = w.shape
    slots = n_walks * length
    steps = slots // batch
    total = max(epochs * steps, 1)
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    for e in range(epochs):
        cw = _compacted(w, keep_p, gen)
        order = torch.randperm(slots, generator=gen, device=dev)
        for i in range(steps):
            lr = alpha - (alpha - min_alpha) * (e * steps + i) / total
            s = order[i * batch:(i + 1) * batch]
            row, pos = s // length, s % length
            centers = cw[row, pos]
            b = torch.randint(1, window + 1, (batch,), generator=gen, device=dev)
            cpos = pos[:, None] + offs[None, :]
            inside = (cpos >= 0) & (cpos < length) & (offs.abs()[None, :] <= b[:, None])
            contexts = cw[row[:, None], cpos.clamp(0, length - 1)]
            negs = torch.multinomial(unigram, batch * negative, replacement=True,
                                     generator=gen).reshape(batch, negative)
            syn0, syn1 = sgns_step(syn0, syn1, centers, contexts, inside & (contexts >= 0),
                                   negs, lr)
    return syn0


def auc_pairs(adj: torch.Tensor, n_pairs: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``n_pairs`` edges drawn without replacement, as many pairs of
    distinct nodes with neighbours that are not adjacent), [n, 2] each,
    drawn from ``seed``."""
    gen = torch.Generator(device=adj.device).manual_seed(seed)
    ei = torch.nonzero(torch.triu(adj, diagonal=1))
    take = torch.randperm(ei.shape[0], generator=gen, device=adj.device)[:n_pairs]
    nodes = torch.nonzero(adj.sum(1) > 0)[:, 0]
    out = torch.empty((0, 2), dtype=torch.int64, device=adj.device)
    while out.shape[0] < take.shape[0]:
        ij = nodes[torch.randint(0, nodes.numel(), (2 * n_pairs, 2), generator=gen,
                                 device=adj.device)]
        ok = (ij[:, 0] != ij[:, 1]) & (adj[ij[:, 0], ij[:, 1]] == 0)
        out = torch.cat([out, ij[ok]])
    return ei[take], out[:take.shape[0]]


def edge_auc(emb: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor) -> float:
    """The area under the ROC curve of dot-product scores: the chance that
    an edge scores above a non-adjacent pair, ties counting half."""
    e = emb.double()
    sp = (e[pos[:, 0]] * e[pos[:, 1]]).sum(1)
    sn = torch.sort((e[neg[:, 0]] * e[neg[:, 1]]).sum(1)).values
    below = torch.searchsorted(sn, sp, right=False).double()
    upto = torch.searchsorted(sn, sp, right=True).double()
    return float(((below + upto) / 2).mean() / sn.numel())
