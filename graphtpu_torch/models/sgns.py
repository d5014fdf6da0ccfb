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

Every :func:`train_sgns` call adds to :data:`SGNS_COUNTS` (read as
differences): its steps, the center slots and negatives they drew (known
on the host) and the valid (center, context) pairs they trained on
(counted on the device, one sum a step, read once at the end).
"""

from __future__ import annotations

import math
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

SGNS_COUNTS = {"steps": 0, "centers": 0, "pairs": 0, "negatives": 0}


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
    # stable compaction: each kept token to its rank among its row's kept
    # tokens, every dropped one to a spare last column (int64 ranks, no
    # sort: a [W, L] sort's keys, values and scratch were the job's peak)
    w = walks.shape[1]
    dest = torch.cumsum(keep, dim=1).sub_(1).masked_fill_(~keep, w)
    out = torch.full((walks.shape[0], w + 1), -1, dtype=walks.dtype, device=walks.device)
    compacted = out.scatter_(1, dest, walks)[:, :w]
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


def sgns_closed_form(v, u, un, centers, contexts, ctx_mask, negatives):
    """The closed-form gradients of :func:`sgns_loss` with respect to the
    looked-up rows ``v = syn0[centers]``, ``u = syn1[contexts]`` and ``un =
    syn1[negatives]`` (``[B, D]``, ``[B, W, D]``, ``[..., N, D]``): (dv,
    du, dun) of the same shapes.  The masks read the ids themselves
    (accidental hits on the context or the center are skipped)."""
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
    return dv, du, dun


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
    dv, du, dun = sgns_closed_form(*_lookups(params, centers, contexts, negatives), centers,
                                   contexts, ctx_mask, negatives)
    d = dv.shape[1]
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
    gensim's sequential update whatever the batch and vocabulary size.  A
    mesh's step is :func:`graphtpu_torch.dist.sgns_dp.sharded_sgns_step`."""
    (g0, g1), (c0, c1) = sgns_manual_grads(params, centers, contexts, mask, negs, n_nodes)
    syn0, syn1 = params
    return (syn0 - lr * (g0 / c0.clamp(min=1)[:, None]),
            syn1 - lr * (g1 / c1.clamp(min=1)[:, None]))


def draw_batch(cwalks: torch.Tensor, slots: torch.Tensor, window: int, neg_j: torch.Tensor,
               neg_q: torch.Tensor, nshape, gen: torch.Generator):
    """(centers, contexts, mask, negatives) of one step on the center
    ``slots`` of the compacted walks: the batch's dynamic windows, then its
    negatives, drawn from ``gen`` in that order."""
    centers, contexts, mask = _gather_batch(cwalks, slots, window, gen)
    return centers, contexts, mask, alias_draw_batch(neg_j, neg_q, gen, nshape)


def _take_step(params: Params, batch, lr, n_nodes: int, shards=None,
               stage_times: Optional[dict] = None) -> Params:
    centers, contexts, mask, negs = batch
    if shards is None:
        return sgns_step(params, centers, contexts, mask, negs, lr, n_nodes)
    from graphtpu_torch.dist.sgns_dp import sharded_sgns_step

    b = centers.shape[0] // shards.n_blocks
    part = slice(shards.block * b, (shards.block + 1) * b)
    return sharded_sgns_step(params, centers[part], contexts[part], mask[part], negs[part], lr,
                             shards, stage_times)


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
    shards=None,
    stage_times: Optional[dict] = None,
) -> Params:
    """One training step on the center ``slots`` of the compacted walks:
    :func:`draw_batch`, then :func:`sgns_step`.  ``shards``
    (:class:`graphtpu_torch.dist.sgns_dp.RowShards`): every rank draws the
    whole batch and steps on its data block with its row shards of the
    tables (``stage_times`` as :func:`~graphtpu_torch.dist.sgns_dp.sharded_sgns_step`
    takes it)."""
    batch = draw_batch(cwalks, slots, window, neg_j, neg_q, nshape, gen)
    return _take_step(params, batch, lr, n_nodes, shards, stage_times)


_CAPTURE_STREAMS: dict = {}


class SgnsSteps:
    """The steps of one :func:`train_sgns` run: :meth:`step` takes
    :func:`batch_step`'s step (:func:`draw_batch`, then :func:`sgns_step`)
    on the epoch's compacted walks (:meth:`epoch`) from the chunk's stream
    (:meth:`chunk`), keeps the batch it drew in ``batch`` (centers,
    contexts, mask, negatives) and adds its valid (center, context) pairs
    to ``pairs`` on the device.

    On one CUDA device (no ``shards``) the first step is captured as one
    CUDA graph and every step replays it: the tables given to the first
    step are copied into static buffers, which every step updates and
    returns, and the slots, the rate and the stream (a generator
    registered with the graph) are static too.  The same kernels in the
    same order on the same random numbers, so the same bits as the eager
    steps, in one launch a step in place of ~150: the card, not the
    host's dispatch of those launches, paces the steps.  Elsewhere each
    step runs eagerly."""

    def __init__(self, window: int, neg_j: torch.Tensor, neg_q: torch.Tensor, nshape,
                 n_nodes: int, shards=None, stage_times: Optional[dict] = None):
        self.window, self.neg = window, (neg_j, neg_q, nshape)
        self.n_nodes, self.shards, self.stage_times = n_nodes, shards, stage_times
        self.dev = neg_j.device
        self.pairs = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.graphed = self.dev.type == "cuda" and shards is None
        self.gen = torch.Generator(device=self.dev)
        self.key = 0
        self.cwalks = self.graph = self.batch = None

    def epoch(self, cwalks: torch.Tensor) -> None:
        if self.graph is None:
            self.cwalks = cwalks
        else:
            self.cwalks.copy_(cwalks)

    def chunk(self, key: int) -> None:
        self.key = key
        self.gen.manual_seed(key)

    def _draw(self, slots):
        self.batch = draw_batch(self.cwalks, slots, self.window, *self.neg, self.gen)
        centers, _, mask, _ = self.batch
        self.pairs.add_((mask & (centers >= 0)[:, None]).sum())
        return self.batch

    def _body(self):
        new = _take_step(self.params, self._draw(self.slots), self.lr, self.n_nodes)
        for p, x in zip(self.params, new):
            p.copy_(x)

    def _capture(self, params: Params, slots: torch.Tensor) -> None:
        self.params = tuple(p.clone() for p in params)
        self.slots = slots.clone()
        self.lr = torch.zeros((), device=self.dev)
        # one side stream a device for every capture: cuBLAS keeps a workspace
        # for each stream it has run on, for the life of the process
        side = _CAPTURE_STREAMS.get(str(self.dev))
        if side is None:
            side = _CAPTURE_STREAMS[str(self.dev)] = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        with torch.cuda.stream(side):
            for _ in range(2):  # the lazy set-up of every kernel, off the graph
                self._body()
            # capture_begin, not torch.cuda.graph: no collection and no emptied
            # cache, whose allocations every later step would pay for again
            self.graph.capture_begin()
            self._body()
            self.graph.capture_end()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        for p, x in zip(self.params, params):  # what the warm-up steps moved
            p.copy_(x)
        self.pairs.zero_()
        self.chunk(self.key)

    def step(self, params: Params, slots: torch.Tensor, lr: float) -> Params:
        if not self.graphed:
            return _take_step(params, self._draw(slots), lr, self.n_nodes, self.shards,
                              self.stage_times)
        if self.graph is None:
            self._capture(params, slots)
        self.slots.copy_(slots)
        self.lr.fill_(lr)
        self.graph.replay()
        return self.params


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


INIT_ROWS = 1 << 16  # rows of one syn0 init chunk, each drawn from its own stream


def init_syn0(key: int, lo: int, rows: int, n_nodes: int, dim: int, device) -> torch.Tensor:
    """Rows [lo, lo + rows) of gensim's syn0 init, U(-0.5/d, 0.5/d); rows
    past ``n_nodes`` are 0.  The table is drawn in fixed chunks of
    ``INIT_ROWS`` rows, chunk k from the stream ``key_for(key, k)``, so a
    rank holding a row block draws only the chunks it overlaps and gets the
    rows one device draws."""
    out = torch.zeros((rows, dim), device=device)
    hi = max(lo, min(lo + rows, n_nodes))
    for k in range(lo // INIT_ROWS, -(-hi // INIT_ROWS)):
        a = k * INIT_ROWS
        chunk = (torch.rand((INIT_ROWS, dim), generator=generator(key_for(key, k), device),
                            device=device) - 0.5) / dim
        s, e = max(a, lo), min(a + INIT_ROWS, hi)
        out[s - lo: e - lo] = chunk[s - a: e - a]
    return out


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
    mesh=None,
    stage_times: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train on a [W, L] walk tensor on ``device`` (default ``cuda``);
    returns (syn0, syn1) as numpy [V, D].

    ``cfg.epochs`` passes over every center slot (gensim iter=10), LR
    decaying linearly across the run.  Steps run in chunks of
    ``chunk_steps``; with ``checkpoint_path``, the state is saved every
    ``checkpoint_every`` chunks and a run finding the file resumes from it.
    syn0's init is drawn in fixed row chunks (:func:`init_syn0`).

    ``mesh`` (:mod:`graphtpu_torch.dist.mesh`): synchronous data parallelism
    over its first ("data") axis with both tables row-sharded over its
    second ("model") axis, if it has one, on the mesh's device (``device``
    is not read).  Every rank holds the walks, draws every batch as one
    device would and steps on its data block (the batch rounded down to a
    multiple of the axis) with its row shards
    (:func:`graphtpu_torch.dist.sgns_dp.sharded_sgns_step`), so a mesh run
    follows the single-device trajectory but for the order of the sums.
    Checkpoints hold the whole tables (graphtpu's format: they resume on
    any mesh shape, or on one device): the model group of data row 0
    gathers them and rank 0 writes; on resume each rank reads its rows.
    The returned tables are gathered onto every rank's host.
    The steps run through :class:`SgnsSteps`: on one CUDA device, as one
    captured CUDA graph replayed a step.
    ``stage_times``: with a mesh, the steps' stage ms and wire bytes
    (:func:`~graphtpu_torch.dist.sgns_dp.sharded_sgns_step`), plus "steps"
    and "table_bytes" (this rank's two tables, or shards).
    """
    from graphtpu_torch.models.checkpoint import load_state, save_state

    shards = None
    if mesh is not None:
        from graphtpu_torch.dist.sgns_dp import gather_params, row_shards, take_rows

        shards = row_shards(mesh, n_nodes)
        device = mesh.device
    dev = resolve_device(device)
    if key is None:
        key = cfg.seed
    walks = walks.to(dev)
    wn, ln = walks.shape
    counts = corpus_counts(walks, n_nodes) if counts is None else counts.to(dev)
    neg_j, neg_q = build_negative_alias(counts, cfg.ns_exponent)

    k_init, k_run = key_for(key, 0), key_for(key, 1)
    lo, rows = (0, n_nodes) if shards is None else (shards.lo, shards.rows)
    # gensim init: syn0 ~ U(-0.5/d, 0.5/d), syn1neg = 0
    syn0 = init_syn0(k_init, lo, rows, n_nodes, cfg.dim, dev)
    syn1 = torch.zeros((rows, cfg.dim), device=dev)

    slots_per_epoch = wn * ln
    # collision normalisation makes per-epoch row movement scale like V/B
    # relative to gensim's sequential SGD, so cap the batch near the
    # vocabulary size to keep small-graph training gensim-equivalent
    batch = min(cfg.batch_size, slots_per_epoch, max(64, n_nodes))
    if shards is not None:
        batch = max(shards.n_blocks, batch - batch % shards.n_blocks)
    steps_per_epoch = slots_per_epoch // batch
    total_steps = max(cfg.epochs * steps_per_epoch, 1)
    chunk = max(1, min(chunk_steps, steps_per_epoch))
    nshape = ((batch, cfg.negative) if cfg.shared_negatives
              else (batch, 2 * cfg.window, cfg.negative))

    def whole_tables(params):
        if shards is None:
            return params[0].cpu().numpy(), params[1].cpu().numpy()
        return gather_params(params, mesh, n_nodes)

    params = (syn0, syn1)
    resume_epoch, resume_start = 0, 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        arrays, _, meta = load_state(checkpoint_path)
        params = (params_from_numpy(arrays["syn0"], arrays["syn1"], dev) if shards is None
                  else tuple(take_rows(arrays[k], shards) for k in ("syn0", "syn1")))
        resume_epoch = meta.get("epoch", 0)
        resume_start = meta.get("next_start", 0)

    done_chunks = 0
    steps = SgnsSteps(cfg.window, neg_j, neg_q, nshape, n_nodes, shards, stage_times)
    with full_fp32():
        for e in range(resume_epoch, cfg.epochs):
            ekey = key_for(k_run, e)
            # the permutation first, its sort's scratch beside the walks alone
            # (each draw has its own stream, so the order changes no bit)
            perm = torch.randperm(slots_per_epoch, generator=generator(key_for(ekey, 0, 1), dev),
                                  device=dev, dtype=torch.int32)
            cwalks, _ = subsample_and_compact(
                walks, counts, cfg.subsample, generator(key_for(ekey, 0, 0), dev))
            steps.epoch(cwalks)
            start0 = resume_start if e == resume_epoch else 0
            for start in range(start0, steps_per_epoch, chunk):
                # streams key off (epoch, chunk start): a resumed run draws
                # what the uninterrupted one drew
                steps.chunk(key_for(ekey, 1, start))
                for i in range(start, min(start + chunk, steps_per_epoch)):
                    gstep = e * steps_per_epoch + i
                    lr = cfg.alpha - (cfg.alpha - cfg.min_alpha) * gstep / total_steps
                    params = steps.step(params, perm[i * batch:(i + 1) * batch], lr)
                    SGNS_COUNTS["steps"] += 1
                    SGNS_COUNTS["centers"] += batch
                    SGNS_COUNTS["negatives"] += math.prod(nshape)
                    if stage_times is not None:
                        stage_times["steps"] = stage_times.get("steps", 0) + 1
                done_chunks += 1
                nxt = start + chunk
                if (checkpoint_path and checkpoint_every and done_chunks % checkpoint_every == 0
                        and (shards is None or shards.block == 0)):
                    arrays = whole_tables(params)
                    if mesh is None or mesh.rank == 0:
                        meta = ({"epoch": e, "next_start": nxt} if nxt < steps_per_epoch
                                else {"epoch": e + 1, "next_start": 0})
                        save_state(checkpoint_path, {"syn0": arrays[0], "syn1": arrays[1]},
                                   step=done_chunks, meta=meta)
    if stage_times is not None:
        stage_times["table_bytes"] = sum(p.numel() * p.element_size() for p in params)
    tables = whole_tables(params)
    SGNS_COUNTS["pairs"] += int(steps.pairs)
    return tables
