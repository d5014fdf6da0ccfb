"""Skip-gram with negative sampling (SGNS), the node2vec trainer
(counterpart of ``graphtpu/models/sgns.py``).

The reference delegates this to gensim ``Word2Vec(walks, size=dims,
window=10, min_count=0, sg=1, workers=8, iter=10)``, hogwild SGD over 8 CPU
threads (``node2vec/src/main.py:92-101``).  This is synchronous minibatch
SGD with gensim-0.13.3 semantics:

  * dynamic windows: per center, the effective window b ~ U{1..window};
  * negative sampling from the unigram^0.75 table over the walk corpus,
    accidental hits on the true context (or the center) masked out; one
    negative set per center shared across its window, or gensim's per-pair
    draws;
  * frequent-token subsampling (gensim ``sample=1e-3``), sentences
    compacted, re-rolled per epoch;
  * linear LR decay alpha -> min_alpha over the whole run.

A step gathers [B] centers x [2*window] contexts x negatives, forms the
closed-form gradients and sums them into table rows with
:func:`graphtpu_torch.kernels.topk.segment_rows_sum`, which gives the same
bits on every run.  Every random draw comes from a stream of
:mod:`graphtpu_torch.core.prng` keyed by (epoch, chunk start), so a run
resumed from a checkpoint reproduces the uninterrupted one.  Embedding =
the input table (syn0).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.core.device import full_fp32, resolve_device
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.topk import segment_rows_sum

Params = Tuple[torch.Tensor, torch.Tensor]


def corpus_counts(walks: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int64 token counts over the walk corpus (gensim builds its vocab
    from the walks, not the graph); -1 padding is not counted."""
    flat = walks.reshape(-1)
    return torch.bincount(torch.where(flat >= 0, flat, n_nodes), minlength=n_nodes + 1)[:n_nodes]


def build_negative_cdf(counts: torch.Tensor, exponent: float = 0.75) -> torch.Tensor:
    """Cumulative unigram^0.75 table (gensim's negative-sampling table as a
    searchsorted cdf)."""
    return torch.cumsum(counts.float().pow(exponent), 0)


def build_negative_alias(counts, exponent: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walker alias table (int32 J, float32 q) for the unigram^exponent
    distribution, built on the host and put where ``counts`` lies.  One
    draw is a uniform index, a gather and a compare."""
    from graphtpu_torch.walks.alias import alias_setup

    dev = counts.device if isinstance(counts, torch.Tensor) else torch.device("cpu")
    c = counts.cpu().numpy() if isinstance(counts, torch.Tensor) else np.asarray(counts)
    w = np.power(c.astype(np.float64), exponent)
    s = w.sum()
    if s <= 0:
        w[:] = 1.0
        s = float(len(w))
    j, q = alias_setup(w / s)
    return (torch.from_numpy(j.astype(np.int32)).to(dev),
            torch.from_numpy(q.astype(np.float32)).to(dev))


def alias_draw_batch(j: torch.Tensor, q: torch.Tensor, gen: torch.Generator, shape) -> torch.Tensor:
    """Vectorised alias draws: int32 samples of ``shape``."""
    idx = torch.randint(0, j.shape[0], shape, generator=gen, device=j.device)
    u = torch.rand(shape, generator=gen, device=j.device)
    return torch.where(u < q[idx], idx.int(), j[idx])


def subsample_and_compact(
    walks: torch.Tensor, counts: torch.Tensor, sample: float, gen: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop frequent tokens and compact each walk row (gensim semantics):
    (compacted walks with -1 tail padding, valid-token mask)."""
    if sample <= 0:
        return walks, walks >= 0
    freq = counts.float() / counts.sum().clamp(min=1)
    keep_p = ((torch.sqrt(freq / sample) + 1.0) * sample / freq.clamp(min=1e-12)).clamp(0.0, 1.0)
    valid = walks >= 0
    tok = walks.clamp(min=0)
    keep = (torch.rand(walks.shape, generator=gen, device=walks.device) < keep_p[tok]) & valid
    # stable compaction: kept tokens first, original order preserved
    w = walks.shape[1]
    pos = torch.arange(w, device=walks.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, pos + w), dim=1)
    compacted = torch.gather(torch.where(keep, walks, -1), 1, order)
    return compacted, compacted >= 0


def _lookups(params: Params, centers, contexts, negatives):
    syn0, syn1 = params
    v = syn0[centers.clamp(min=0)]      # [B, D]
    u = syn1[contexts.clamp(min=0)]     # [B, W2, D]
    un = syn1[negatives]                # [..., N, D]
    return v, u, un


def _shared_coeff(m, centers, contexts, negatives) -> torch.Tensor:
    """[B, N]: for shared negatives, the count of valid window slots each
    negative's pair counts in (accidental hits skipped, as gensim does)."""
    return (
        m[:, :, None]
        & (negatives[:, None, :] != contexts[..., None])
        & (negatives != centers[:, None])[:, None, :]
    ).sum(dim=1)


def sgns_loss(
    params: Params,
    centers: torch.Tensor,     # [B]
    contexts: torch.Tensor,    # [B, W2]
    ctx_mask: torch.Tensor,    # [B, W2] bool
    negatives: torch.Tensor,   # [B, W2, N] per pair (gensim) or [B, N] shared
) -> torch.Tensor:
    """-(sum of log sigma(v.u) over true pairs + log sigma(-v.u_n) over
    negatives).  A SUM: with the per-row collision normalisation of
    :func:`sgns_step`, one batched step moves a row as much as gensim's
    sequential per-pair updates."""
    v, u, un = _lookups(params, centers, contexts, negatives)
    pos_logit = torch.einsum("bd,bwd->bw", v, u)
    m = ctx_mask & (centers >= 0)[:, None]
    pos_l = F.logsigmoid(pos_logit) * m
    if negatives.dim() == 3:
        neg_logit = torch.einsum("bd,bwnd->bwn", v, un)
        neg_mask = (negatives != contexts[..., None]) & (negatives != centers[:, None, None])
        neg_sum = (F.logsigmoid(-neg_logit) * (m[..., None] & neg_mask)).sum()
    else:
        neg_logit = torch.einsum("bd,bnd->bn", v, un)
        coeff = _shared_coeff(m, centers, contexts, negatives)
        neg_sum = (F.logsigmoid(-neg_logit) * coeff).sum()
    return -(pos_l.sum() + neg_sum)


def sgns_manual_grads(
    params: Params,
    centers: torch.Tensor,
    contexts: torch.Tensor,
    ctx_mask: torch.Tensor,
    negatives: torch.Tensor,
    n_nodes: int,
):
    """Closed-form gradients of :func:`sgns_loss`, summed into table rows by
    :func:`segment_rows_sum`, with each row's occurrence count for the
    collision normalisation.  Returns ((g0, g1), (c0, c1))."""
    syn0, _ = params
    v, u, un = _lookups(params, centers, contexts, negatives)
    pos_logit = torch.einsum("bd,bwd->bw", v, u)
    m = ctx_mask & (centers >= 0)[:, None]
    # d(-log sigma(x))/dx = sigma(x) - 1 ; d(-log sigma(-x))/dx = sigma(x)
    g_pos = (torch.sigmoid(pos_logit) - 1.0) * m           # [B, W]
    du = g_pos[..., None] * v[:, None, :]                  # [B, W, D]
    if negatives.dim() == 3:
        neg_logit = torch.einsum("bd,bwnd->bwn", v, un)
        neg_mask = (negatives != contexts[..., None]) & (negatives != centers[:, None, None])
        g_neg = torch.sigmoid(neg_logit) * (m[..., None] & neg_mask)   # [B, W, N]
        dv = torch.einsum("bw,bwd->bd", g_pos, u) + torch.einsum("bwn,bwnd->bd", g_neg, un)
        dun = g_neg[..., None] * v[:, None, None, :]       # [B, W, N, D]
    else:
        neg_logit = torch.einsum("bd,bnd->bn", v, un)
        g_neg = torch.sigmoid(neg_logit) * _shared_coeff(m, centers, contexts, negatives)
        dv = torch.einsum("bw,bwd->bd", g_pos, u) + torch.einsum("bn,bnd->bd", g_neg, un)
        dun = g_neg[..., None] * v[:, None, :]             # [B, N, D]
    d = syn0.shape[1]
    g0, c0 = segment_rows_sum(centers, dv, n_nodes)
    idx1 = torch.cat([torch.where(ctx_mask, contexts, -1).reshape(-1), negatives.reshape(-1)])
    g1, c1 = segment_rows_sum(idx1, torch.cat([du.reshape(-1, d), dun.reshape(-1, d)]), n_nodes)
    return (g0, g1), (c0, c1)


def sgns_step(
    params: Params,
    centers: torch.Tensor,
    contexts: torch.Tensor,
    mask: torch.Tensor,
    negs: torch.Tensor,
    lr: float,
    n_nodes: int,
) -> Params:
    """One SGD step.  Collision normalisation: a row hit k times in the batch
    moves by its summed gradient over k, so the per-occurrence step matches
    gensim's sequential update whatever the batch and vocabulary size."""
    (g0, g1), (c0, c1) = sgns_manual_grads(params, centers, contexts, mask, negs, n_nodes)
    syn0, syn1 = params
    return (syn0 - lr * (g0 / c0.clamp(min=1)[:, None]),
            syn1 - lr * (g1 / c1.clamp(min=1)[:, None]))


def batch_step(
    params: Params,
    cwalks: torch.Tensor,
    slots: torch.Tensor,
    window: int,
    neg_j: torch.Tensor,
    neg_q: torch.Tensor,
    nshape,
    gen: torch.Generator,
    lr: float,
    n_nodes: int,
) -> Params:
    """One training step on the center ``slots`` of the compacted walks:
    the batch's dynamic windows, then its negatives, drawn from ``gen`` in
    that order, then :func:`sgns_step`."""
    centers, contexts, mask = _gather_batch(cwalks, slots, window, gen)
    negs = alias_draw_batch(neg_j, neg_q, gen, nshape)
    return sgns_step(params, centers, contexts, mask, negs, lr, n_nodes)


def _gather_batch(
    walks: torch.Tensor,                         # [W, L] compacted
    slots: torch.Tensor,                         # [B] flat center slots (walk*L + pos)
    window: int,
    b: Union[torch.Tensor, torch.Generator],     # [B] radii in 1..window, or their stream
):
    """(centers [B], contexts [B, 2*window], mask [B, 2*window]) of a batch;
    ``b`` is each center's dynamic window radius, drawn here from ``b``
    when it is a generator."""
    _, ln = walks.shape
    dev = walks.device
    wi, pos = slots // ln, slots % ln
    centers = walks[wi, pos]
    if isinstance(b, torch.Generator):
        b = torch.randint(1, window + 1, (slots.shape[0],), generator=b, device=dev)
    r = torch.arange(2 * window, device=dev)
    offs = torch.where(r < window, r - window, r - window + 1)   # -w..-1, 1..w
    cpos = pos[:, None] + offs[None, :]
    inb = (cpos >= 0) & (cpos < ln) & (offs.abs()[None, :] <= b[:, None])
    contexts = walks[wi[:, None], cpos.clamp(0, ln - 1)]
    return centers, contexts, inb & (contexts >= 0)


def params_from_numpy(syn0: np.ndarray, syn1: np.ndarray, device) -> Params:
    """(syn0, syn1) as float32 tensors on ``device``: graphtpu's trained
    tables, or a checkpoint's."""
    return (torch.as_tensor(np.asarray(syn0), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(syn1), dtype=torch.float32, device=device))


def train_sgns(
    walks: torch.Tensor,
    n_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    key: Optional[int] = None,
    counts: Optional[torch.Tensor] = None,
    chunk_steps: int = 200,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train on a [W, L] walk tensor on ``device`` (default ``cuda``);
    returns (syn0, syn1) as numpy [V, D].

    ``cfg.epochs`` passes over every center slot (gensim iter=10), LR
    decaying linearly across the run.  Steps run in chunks of
    ``chunk_steps``; with ``checkpoint_path``, the state is saved every
    ``checkpoint_every`` chunks and a run finding the file resumes from it.
    """
    from graphtpu_torch.models.checkpoint import load_state, save_state

    dev = resolve_device(device)
    if key is None:
        key = cfg.seed
    walks = walks.to(dev)
    wn, ln = walks.shape
    counts = corpus_counts(walks, n_nodes) if counts is None else counts.to(dev)
    neg_j, neg_q = build_negative_alias(counts, cfg.ns_exponent)

    k_init, k_run = key_for(key, 0), key_for(key, 1)
    # gensim init: syn0 ~ U(-0.5/d, 0.5/d), syn1neg = 0
    syn0 = (torch.rand((n_nodes, cfg.dim), generator=generator(k_init, dev), device=dev)
            - 0.5) / cfg.dim
    syn1 = torch.zeros((n_nodes, cfg.dim), device=dev)

    slots_per_epoch = wn * ln
    # collision normalisation makes per-epoch row movement scale like V/B
    # relative to gensim's sequential SGD, so cap the batch near the
    # vocabulary size to keep small-graph training gensim-equivalent
    batch = min(cfg.batch_size, slots_per_epoch, max(64, n_nodes))
    steps_per_epoch = slots_per_epoch // batch
    total_steps = max(cfg.epochs * steps_per_epoch, 1)
    chunk = max(1, min(chunk_steps, steps_per_epoch))
    nshape = ((batch, cfg.negative) if cfg.shared_negatives
              else (batch, 2 * cfg.window, cfg.negative))

    params = (syn0, syn1)
    resume_epoch, resume_start = 0, 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        arrays, _, meta = load_state(checkpoint_path)
        params = params_from_numpy(arrays["syn0"], arrays["syn1"], dev)
        resume_epoch = meta.get("epoch", 0)
        resume_start = meta.get("next_start", 0)

    done_chunks = 0
    with full_fp32():
        for e in range(resume_epoch, cfg.epochs):
            ekey = key_for(k_run, e)
            cwalks, _ = subsample_and_compact(
                walks, counts, cfg.subsample, generator(key_for(ekey, 0, 0), dev))
            perm = torch.randperm(slots_per_epoch, generator=generator(key_for(ekey, 0, 1), dev),
                                  device=dev)
            start0 = resume_start if e == resume_epoch else 0
            for start in range(start0, steps_per_epoch, chunk):
                # streams key off (epoch, chunk start): a resumed run draws
                # what the uninterrupted one drew
                gen = generator(key_for(ekey, 1, start), dev)
                for i in range(start, min(start + chunk, steps_per_epoch)):
                    gstep = e * steps_per_epoch + i
                    lr = cfg.alpha - (cfg.alpha - cfg.min_alpha) * gstep / total_steps
                    params = batch_step(params, cwalks, perm[i * batch:(i + 1) * batch],
                                        cfg.window, neg_j, neg_q, nshape, gen, lr, n_nodes)
                done_chunks += 1
                nxt = start + chunk
                if checkpoint_path and checkpoint_every and done_chunks % checkpoint_every == 0:
                    meta = ({"epoch": e, "next_start": nxt} if nxt < steps_per_epoch
                            else {"epoch": e + 1, "next_start": 0})
                    save_state(
                        checkpoint_path,
                        {"syn0": params[0].cpu().numpy(), "syn1": params[1].cpu().numpy()},
                        step=done_chunks, meta=meta,
                    )
    return params[0].cpu().numpy(), params[1].cpu().numpy()
