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

A step gathers [B] centers x [2*window] contexts x negatives and forms
the closed-form gradients summed into table rows, in a fixed order that
gives the same bits on every run.  On a CUDA device with shared negatives
the kernel pair SG1 (``kernels/csrc/sgns.cu``, :func:`sg1_grads`) forms
them from per-pair scalar coefficients, with no [B, 2*window, D] rows;
elsewhere (the CPU, gensim's per-pair negatives) the gradient rows are
summed by :func:`graphtpu_torch.kernels.topk.segment_rows_sum`.  Every
random draw comes from a stream of :mod:`graphtpu_torch.core.prng` keyed
by (epoch, chunk start), so a run resumed from a checkpoint reproduces the
uninterrupted one.  Embedding = the input table (syn0).

Every :func:`train_sgns` call adds to :data:`SGNS_COUNTS` (read as
differences): its steps, the center slots and negatives they drew (known
on the host), the valid (center, context) pairs they trained on (counted
on the device, one sum a step, read once at the end) and the steps whose
gradients SG1 formed (``fused_steps``).
"""

from __future__ import annotations

import ctypes
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

SGNS_COUNTS = {"steps": 0, "centers": 0, "pairs": 0, "negatives": 0, "fused_steps": 0}
# SG1's kernels' launches from the host: a call outside a CUDA graph's
# capture runs them, a call inside one records them into the graph, whose
# replays run them again without the host
SG1_LAUNCHES = {"coeffs": 0, "chunks": 0, "finish": 0}
SG1_CHUNK = 32  # sorted items a chunk of SG1b (kChunk of kernels/csrc/sgns.cu)


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
    """Closed-form gradients of :func:`sgns_loss` summed into table rows,
    with each row's occurrence count for the collision normalisation:
    a center counts where it is >= 0, a context where ``ctx_mask`` holds,
    a negative always.  Returns ((g0, g1), (c0, c1)).

    On a CUDA device with shared negatives (2-D) SG1 forms them
    (:func:`sg1_grads`); elsewhere the gradient rows are summed by
    :func:`segment_rows_sum`."""
    if centers.device.type == "cuda" and negatives.dim() == 2:
        return sg1_grads(params, centers, contexts, ctx_mask, negatives, n_nodes)
    return _segment_grads(params, centers, contexts, ctx_mask, negatives, n_nodes)


def _segment_grads(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int):
    """:func:`sgns_manual_grads` by gradient rows: :func:`sgns_closed_form`,
    then :func:`segment_rows_sum` of the centers' and of the contexts' and
    negatives' rows."""
    dv, du, dun = sgns_closed_form(*_lookups(params, centers, contexts, negatives), centers,
                                   contexts, ctx_mask, negatives)
    d = dv.shape[1]
    g0, c0 = segment_rows_sum(centers, dv, n_nodes)
    idx1 = torch.cat([torch.where(ctx_mask, contexts, -1).reshape(-1), negatives.reshape(-1)])
    g1, c1 = segment_rows_sum(idx1, torch.cat([du.reshape(-1, d), dun.reshape(-1, d)]), n_nodes)
    return (g0, g1), (c0, c1)


# SG1 (kernels/csrc/sgns.cu) and its plain version.  An item is a context
# slot, a negative or a center, in that order, batch-major; its sort key is
# the table row it adds to: syn1's row r as r, syn0's row r as n_nodes + 1 +
# r, and n_nodes for a masked context or a center < 0 (summed nowhere).


def check_sg1_args(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int) -> None:
    """Raise on what SG1 does not take: tables other than contiguous [., D]
    float32 ones with D <= 512, a batch whose shapes disagree ([B]
    centers, [B, 2w] contexts and mask, [B, N] negatives), more than 2^31
    items or rows, or tensors on more than one device.  Checks only: runs
    before any launch, on any device."""
    syn0, syn1 = params
    for name, t in (("syn0", syn0), ("syn1", syn1)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"SG1 takes contiguous [V, D] float32 tables; {name} is {t.dtype} "
                            f"{tuple(t.shape)}")
    d = syn0.shape[1]
    if syn1.shape[1] != d or not 1 <= d <= 512:
        raise ValueError(f"SG1 takes tables of one width of 1 to 512, got {syn0.shape[1]} and "
                         f"{syn1.shape[1]}")
    if centers.dim() != 1 or contexts.dim() != 2 or negatives.dim() != 2:
        raise ValueError("SG1 takes [B] centers, [B, 2w] contexts and [B, N] shared negatives")
    b, w2 = contexts.shape
    if centers.shape[0] != b or tuple(ctx_mask.shape) != (b, w2) or negatives.shape[0] != b:
        raise ValueError(f"SG1's batch disagrees: centers {tuple(centers.shape)}, contexts "
                         f"{tuple(contexts.shape)}, mask {tuple(ctx_mask.shape)}, negatives "
                         f"{tuple(negatives.shape)}")
    if b < 1 or w2 < 1 or max(b * (w2 + negatives.shape[1] + 1), 2 * n_nodes + 1) >= 1 << 31:
        raise ValueError(f"SG1 takes 1 to 2^31 items and rows, got B = {b}, 2w = {w2}, "
                         f"V = {n_nodes}")
    for name, t in (("syn1", syn1), ("centers", centers), ("contexts", contexts),
                    ("ctx_mask", ctx_mask), ("negatives", negatives)):
        if t.device != syn0.device:
            raise ValueError(f"SG1 takes its tensors on one device: {name} is on {t.device}, "
                             f"syn0 on {syn0.device}")


def _ids(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def sg1_coeffs(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int):
    """SG1a, one launch on the current stream: (g [B, 2w + N] float32, dv
    [B, D] float32, keys [B (2w + N + 1)] int32), as
    :func:`_sg1_coeffs_plain` gives them."""
    from graphtpu_torch.kernels import _build

    check_sg1_args(params, centers, contexts, ctx_mask, negatives, n_nodes)
    syn0, syn1 = params
    centers, contexts, negatives = _ids(centers), _ids(contexts), _ids(negatives)
    ctx_mask = _ids(ctx_mask, torch.bool)
    (b, w2), nn, d = contexts.shape, negatives.shape[1], syn0.shape[1]
    g = torch.empty((b, w2 + nn), dtype=torch.float32, device=syn0.device)
    dv = torch.empty((b, d), dtype=torch.float32, device=syn0.device)
    keys = torch.empty(b * (w2 + nn + 1), dtype=torch.int32, device=syn0.device)
    lib = _build.load()
    with torch.cuda.device(syn0.device):
        rc = lib.gt_sg1_coeffs(
            syn0.data_ptr(), syn1.data_ptr(), centers.data_ptr(), contexts.data_ptr(),
            ctx_mask.data_ptr(), negatives.data_ptr(), g.data_ptr(), dv.data_ptr(),
            keys.data_ptr(), b, w2, nn, d, n_nodes,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"SG1a launch failed: {_build.error_string(rc)}")
    SG1_LAUNCHES["coeffs"] += 1
    return g, dv, keys


def sg1_rows(syn0: torch.Tensor, centers, g, dv, keys, w2: int, n_nodes: int):
    """SG1b on the current stream, after :func:`sg1_coeffs` over ``w2``
    context slots: the keys' stable sort (``torch.sort`` on int32), then
    a memset and two launches (``chunks``, ``finish``): ((g0, g1), (c0,
    c1)), as :func:`_sg1_rows_plain` gives them.  g1 and g0 are rows
    0..V-1 and V+1..2V of one [2V + 1, D] tensor, the counts likewise."""
    from graphtpu_torch.kernels import _build

    if keys.dtype != torch.int32 or g.dtype != torch.float32 or dv.dtype != torch.float32:
        raise TypeError("SG1b takes int32 keys and float32 coefficients and dv")
    centers, g, dv, keys = _ids(centers), g.contiguous(), dv.contiguous(), keys.contiguous()
    (b, s), d, v, n = g.shape, dv.shape[1], n_nodes, keys.numel()
    skeys, order = torch.sort(keys, stable=True)
    dev = syn0.device
    out = torch.empty((2 * v + 1, d), dtype=torch.float32, device=dev)
    counts = torch.empty(2 * v + 1, dtype=torch.float32, device=dev)
    partial = torch.empty((-(-n // SG1_CHUNK), 2, d), dtype=torch.float32, device=dev)
    bounds = torch.empty((2, 2 * v + 1), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.gt_sg1_rows(
            skeys.data_ptr(), order.data_ptr(), g.data_ptr(), dv.data_ptr(), syn0.data_ptr(),
            centers.data_ptr(), out.data_ptr(), partial.data_ptr(), bounds.data_ptr(),
            counts.data_ptr(), n, b, w2, s - w2, d, v,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"SG1b launch failed: {_build.error_string(rc)}")
    SG1_LAUNCHES["chunks"] += 1
    SG1_LAUNCHES["finish"] += 1
    return (out[v + 1:], out[:v]), (counts[v + 1:], counts[:v])


def sg1_grads(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int):
    """:func:`sgns_manual_grads` by SG1 on the current stream, or raises:
    :func:`sg1_coeffs`, then :func:`sg1_rows`.  No host sync, so a CUDA
    graph can hold it."""
    g, dv, keys = sg1_coeffs(params, centers, contexts, ctx_mask, negatives, n_nodes)
    return sg1_rows(params[0], centers, g, dv, keys, contexts.shape[1], n_nodes)


def _sg1_coeffs_plain(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int):
    """SG1a's (g, dv, keys) in PyTorch ops: a context slot's coefficient
    sigma(v.u) - 1 where it is valid and its center >= 0, a negative's
    sigma(v.u) times its count of such slots that it does not hit (nor the
    center), 0 elsewhere; dv = the coefficients times the syn1 rows."""
    syn0, syn1 = params
    w2 = contexts.shape[1]
    m = ctx_mask & (centers >= 0)[:, None]
    v = syn0[centers.clamp(min=0)]                                    # [B, D]
    rows = syn1[torch.cat([contexts.clamp(min=0), negatives], 1)]     # [B, 2w + N, D]
    x = torch.einsum("bd,bsd->bs", v, rows)
    g = torch.cat([torch.where(m, torch.sigmoid(x[:, :w2]) - 1.0, 0.0),
                   torch.sigmoid(x[:, w2:]) * _shared_coeff(m, centers, contexts, negatives)], 1)
    dv = torch.einsum("bs,bsd->bd", g, rows)
    keys = torch.cat([torch.where(ctx_mask, contexts, n_nodes).reshape(-1),
                      negatives.reshape(-1),
                      torch.where(centers >= 0, centers + n_nodes + 1, n_nodes)]).int()
    return g, dv, keys


def _sg1_rows_plain(syn0: torch.Tensor, centers, g, dv, keys, w2: int, n_nodes: int,
                    chunk: int = SG1_CHUNK):
    """SG1b's ((g0, g1), (c0, c1)) in PyTorch ops, summed as the kernel
    sums: the items' rows (a context's or negative's coefficient times its
    center's syn0 row, a center's dv row) in the keys' stable order, each
    run of one key within a chunk of ``chunk`` sorted items summed in
    order, then each key's runs in chunk order."""
    v, d = n_nodes, dv.shape[1]
    vc = syn0[centers.clamp(min=0)]
    items = torch.cat([(g[:, :w2, None] * vc[:, None, :]).reshape(-1, d),
                       (g[:, w2:, None] * vc[:, None, :]).reshape(-1, d), dv])
    skeys, order = torch.sort(keys.long(), stable=True)
    rows = items[order]
    # a run: one key within one chunk (pieces of a key come out in chunk order)
    run = torch.arange(len(skeys), device=skeys.device) // chunk * (2 * v + 2) + skeys
    run_id, run_len = torch.unique_consecutive(run, return_counts=True)
    sums = torch.segment_reduce(rows, "sum", lengths=run_len, axis=0)
    key_id, key_runs = torch.unique_consecutive(run_id % (2 * v + 2), return_counts=True)
    out = torch.zeros((2 * v + 2, d), dtype=torch.float32, device=syn0.device)
    out[key_id] = torch.segment_reduce(sums, "sum", lengths=key_runs, axis=0)
    counts = torch.bincount(skeys, minlength=2 * v + 2).float()
    return (out[v + 1:2 * v + 1], out[:v]), (counts[v + 1:2 * v + 1], counts[:v])


def _sgns_grads_plain(params: Params, centers, contexts, ctx_mask, negatives, n_nodes: int,
                      chunk: int = SG1_CHUNK):
    """SG1's two stages in PyTorch ops (:func:`_sg1_coeffs_plain`, then
    :func:`_sg1_rows_plain`): what the tests hold the kernel to."""
    g, dv, keys = _sg1_coeffs_plain(params, centers, contexts, ctx_mask, negatives, n_nodes)
    return _sg1_rows_plain(params[0], centers, g, dv, keys, contexts.shape[1], n_nodes, chunk)


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
    contexts, mask, negatives), adds its valid (center, context) pairs
    to ``pairs`` on the device and sets ``fused`` where SG1 formed its
    gradients (set when a step is taken in Python: a replay keeps the
    captured step's).

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
        self.fused = False
        self.cwalks = self.graph = self.batch = None

    def epoch(self, cwalks: torch.Tensor) -> None:
        if self.graph is None:
            self.cwalks = cwalks
        else:
            self.cwalks.copy_(cwalks)

    def chunk(self, key: int) -> None:
        self.key = key
        self.gen.manual_seed(key)

    def _take(self, params: Params, slots, lr, shards=None, stage_times=None) -> Params:
        """:func:`draw_batch`, then the step; ``fused`` says whether SG1
        formed its gradients."""
        self.batch = draw_batch(self.cwalks, slots, self.window, *self.neg, self.gen)
        centers, _, mask, _ = self.batch
        self.pairs.add_((mask & (centers >= 0)[:, None]).sum())
        launched = SG1_LAUNCHES["coeffs"]
        new = _take_step(params, self.batch, lr, self.n_nodes, shards, stage_times)
        self.fused = SG1_LAUNCHES["coeffs"] > launched
        return new

    def _body(self):
        for p, x in zip(self.params, self._take(self.params, self.slots, self.lr)):
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
            return self._take(params, slots, lr, self.shards, self.stage_times)
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
                    SGNS_COUNTS["fused_steps"] += steps.fused
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
