"""DeepSim: an autoencoder over SimRank-valued walk windows (counterpart of
``graphtpu/models/deepsim.py``).

Reference (``DeepSim/src/DeepSim.py:111-195,268-342``): a one-hidden-layer
AE |V| -> d -> |V|; the input is the one-hot of a walk-window center, the
target is a |V|-vector holding simrank(center, j) at the 2k+1 window
positions (pairs missing from the top-k sim list get the center's minimum
known sim); softmax cross-entropy on the raw simrank labels; Adam lr 1e-3,
minibatch 128, 50k iterations; the embedding is W1 [V, d].

Here:
  * the one-hot product x @ W1 is a row gather W1[center], whose gradient
    is summed into W1's rows by the sorted, atomic-free
    :func:`graphtpu_torch.kernels.topk.segment_rows_sum`, so seeded runs on
    the card give the same bits;
  * W1's gradient is dense, so rows not drawn in a step still move through
    Adam's moments, as under ``optax.adam`` (``torch.optim.Adam`` uses the
    same update: b1 0.9, b2 0.999, eps 1e-8 outside the square root);
  * sim lookups bisect the id-sorted top-k rows (``torch.searchsorted``,
    left side);
  * the reference indexes ``tem_simrank[location]`` (walk position) at
    ``DeepSim.py:321``, an indexing bug; this implements the evident intent
    ``tem_simrank[center]``, as graphtpu does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graphtpu_torch.core.config import DeepSimConfig
from graphtpu_torch.core.device import full_fp32, resolve_device
from graphtpu_torch.core.prng import generator, key_for
from graphtpu_torch.kernels.topk import segment_rows_sum

SimTable = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # ids [V,K], vals [V,K], min [V]
Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # W1, b1, W2, b2

CHUNK = 200  # graphtpu's scan chunk, which fixes where checkpoints fall


def build_sim_table(
    sim_dict: Dict[int, List[Tuple[int, float]]], n_nodes: int, k_max: int = 0,
    device="cpu",
) -> SimTable:
    """Pack {src: [(nbr, sim), ...]} into id-sorted padded arrays on
    ``device``: sims <= 1e-8 dropped, rows sorted by neighbour id and padded
    with int32 max, each row's minimum sim as its fallback label."""
    if k_max <= 0:
        k_max = max((len(v) for v in sim_dict.values()), default=1)
    ids = np.full((n_nodes, k_max), np.iinfo(np.int32).max, np.int32)
    vals = np.zeros((n_nodes, k_max), np.float32)
    mins = np.zeros((n_nodes,), np.float32)
    for src, pairs in sim_dict.items():
        pairs = [(i, v) for i, v in pairs if v > 1e-8][:k_max]
        if not pairs:
            continue
        pairs.sort()
        ids[src, : len(pairs)] = [i for i, _ in pairs]
        vals[src, : len(pairs)] = [v for _, v in pairs]
        mins[src] = min(v for _, v in pairs)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, vals, mins))


def lookup_sim(table: SimTable, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """sim(src, dst) with the min-sim fallback; src [B], dst [B, W]."""
    ids, vals, mins = table
    src = src.long()
    rows_i = ids[src]                                    # [B, K]
    pos = torch.searchsorted(rows_i, dst.to(ids.dtype).contiguous(), right=False)
    pos = pos.clamp(max=ids.shape[1] - 1)
    hit = rows_i.gather(1, pos) == dst
    return torch.where(hit, vals[src].gather(1, pos), mins[src][:, None])


def init_params(cfg: DeepSimConfig, n_nodes: int, key: int, device) -> Params:
    """W1 [V, d] and W2 [d, V] from 0.1 x a normal truncated at 2 standard
    deviations, zero biases."""
    gen = generator(key, device)

    def trunc(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return 0.1 * nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)

    w1 = trunc((n_nodes, cfg.dim))
    w2 = trunc((cfg.dim, n_nodes))
    return (w1, torch.zeros(cfg.dim, device=device), w2, torch.zeros(n_nodes, device=device))


def params_from_numpy(params: Sequence[np.ndarray], device) -> Params:
    """(W1, b1, W2, b2) as float32 tensors on ``device``: graphtpu's
    ``init_params`` or trained parameters."""
    return tuple(torch.tensor(np.asarray(p), dtype=torch.float32, device=device)
                 for p in params)


class _RowGather(torch.autograd.Function):
    """W1[centers], with the row gradient summed by a stable sort and one
    sequential sum per row instead of float atomics."""

    @staticmethod
    def forward(ctx, w1, centers):
        ctx.save_for_backward(centers)
        ctx.n_rows = w1.shape[0]
        return w1.index_select(0, centers)

    @staticmethod
    def backward(ctx, grad):
        (centers,) = ctx.saved_tensors
        return segment_rows_sum(centers, grad, ctx.n_rows)[0], None


def deepsim_loss(
    params: Params,
    centers: torch.Tensor,        # [B]
    window_ids: torch.Tensor,     # [B, 2k+1] node ids in the window
    window_vals: torch.Tensor,    # [B, 2k+1] simrank labels
) -> torch.Tensor:
    """Softmax cross-entropy between full-vocabulary logits and the sparse
    simrank target: tf's ``softmax_cross_entropy_with_logits`` against the
    dense |V| target holding window_vals at window_ids and 0 elsewhere."""
    w1, b1, w2, b2 = params
    hidden = F.relu(_RowGather.apply(w1, centers.long()) + b1)  # == relu(onehot @ W1 + b1)
    logits = torch.matmul(hidden, w2) + b2                      # [B, V]
    logz = F.log_softmax(logits, dim=-1)
    picked = logz.gather(1, window_ids.long())
    return -(window_vals * picked).sum(dim=1).mean()


class DeepSim(nn.Module):
    """The autoencoder's parameters; the embedding is ``w1``."""

    def __init__(self, params: Params):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (nn.Parameter(p.detach().clone()) for p in params)

    def params(self) -> Params:
        return self.w1, self.b1, self.w2, self.b2

    def loss(self, centers, window_ids, window_vals) -> torch.Tensor:
        return deepsim_loss(self.params(), centers, window_ids, window_vals)


def window_batch(
    walks: torch.Tensor, table: SimTable, wi: torch.Tensor, pos: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(centers [B], window ids [B, 2k+1], labels [B, 2k+1]) for the drawn
    walks ``wi`` and positions ``pos``.  A window slot past a dead end (-1)
    takes the center; a node id repeated inside a window keeps its label
    only at its first slot, as the reference's dense target writes each id
    once (``DeepSim.py:327-338``)."""
    offs = torch.arange(-k, k + 1, device=walks.device)
    wi, pos = wi.long(), pos.long()
    centers = walks[wi, pos]
    win = walks[wi[:, None], pos[:, None] + offs[None, :]]
    win = torch.where(win >= 0, win, centers[:, None])
    vals = lookup_sim(table, centers, win)
    slot = torch.arange(2 * k + 1, device=walks.device)
    dup = (win[:, :, None] == win[:, None, :]) & (slot[None, :, None] > slot[None, None, :])
    vals = torch.where(dup.any(dim=2), 0.0, vals)
    # a center past a dead end is -1, which graphtpu's gathers read as the
    # last row (numpy indexing); the same here, after the labels
    n = table[0].shape[0]
    return (torch.where(centers < 0, centers + n, centers),
            torch.where(win < 0, win + n, win), vals)


def checkpoint_steps(steps: int, checkpoint_every: int) -> List[int]:
    """The step indices at which graphtpu's ``train_deepsim`` calls its
    ``checkpoint_fn``: the last step of each scan chunk (min(every, 200)
    steps) that crosses a multiple of ``checkpoint_every``."""
    if not checkpoint_every:
        return []
    chunk = max(1, min(checkpoint_every, CHUNK))
    out, i = [], 0
    while i < steps:
        m = min(chunk, steps - i)
        if i // checkpoint_every != (i + m) // checkpoint_every:
            out.append(i + m - 1)
        i += m
    return out


class Trainer:
    """One run's state on one device: the model from ``params``, Adam, the
    walks, the sim table and the stream of drawn (walk, position) pairs."""

    def __init__(self, walks, table: SimTable, params: Params, cfg: DeepSimConfig, key: int,
                 device):
        self.cfg, self.dev = cfg, device
        self.walks = torch.as_tensor(walks, dtype=torch.int32).to(device)
        if self.walks.shape[1] <= 2 * cfg.window:
            raise ValueError(f"walk length {self.walks.shape[1]} must exceed twice the window "
                             f"{cfg.window}")
        self.table = tuple(t.to(device) for t in table)
        self.model = DeepSim(tuple(p.to(device) for p in params))
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.learning_rate)
        self.gen = generator(key, device)

    def draws(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The next minibatch's walk rows and window centres' positions."""
        (wn, ln), k, b = self.walks.shape, self.cfg.window, self.cfg.minibatch
        return (torch.randint(0, wn, (b,), generator=self.gen, device=self.dev),
                torch.randint(k, ln - k, (b,), generator=self.gen, device=self.dev))

    def step(self, wi: Optional[torch.Tensor] = None,
             pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Adam step on the drawn windows (or on ``wi``, ``pos``);
        returns the loss, detached.  Call inside ``full_fp32()``."""
        if wi is None:
            wi, pos = self.draws()
        loss = self.model.loss(*window_batch(self.walks, self.table, wi, pos, self.cfg.window))
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss.detach()


def train_deepsim(
    walks,
    sim_table: SimTable,
    n_nodes: int,
    cfg: DeepSimConfig = DeepSimConfig(),
    key: Optional[int] = None,
    steps: Optional[int] = None,
    checkpoint_every: int = 0,
    checkpoint_fn: Optional[Callable[[int, np.ndarray], None]] = None,
    device=None,
    losses: Optional[list] = None,
) -> np.ndarray:
    """Train on ``device`` (default ``cuda``); returns the embedding W1
    [V, dim] as numpy.

    ``walks``: int [N, L] (tensor or array; -1 past a dead end).  ``key``
    (default ``cfg.seed``) seeds the initial weights (stream 0) and the
    drawn (walk, position) pairs (stream 1).  ``checkpoint_fn(step, emb)``
    is called at graphtpu's step indices (:func:`checkpoint_steps`).
    ``losses``: if a list, receives each step's loss as a float.
    """
    dev = resolve_device(device)
    key = cfg.seed if key is None else key
    steps = cfg.steps if steps is None else steps
    trainer = Trainer(walks, sim_table, init_params(cfg, n_nodes, key_for(key, 0), dev), cfg,
                      key_for(key, 1), dev)
    ckpt = set(checkpoint_steps(steps, checkpoint_every)) if checkpoint_fn else set()
    step_losses = []
    with full_fp32():
        for i in range(steps):
            loss = trainer.step()
            if losses is not None:
                step_losses.append(loss)
            if i in ckpt:
                checkpoint_fn(i, trainer.model.w1.detach().cpu().numpy())
    if losses is not None and step_losses:
        losses.extend(torch.stack(step_losses).tolist())
    return trainer.model.w1.detach().cpu().numpy()
