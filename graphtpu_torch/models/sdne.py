"""The SDNE scaffold autoencoder (counterpart of ``graphtpu/models/sdne.py``).

The reference "SDNE" (``SDNE/SDNE.py:66-176``) is a sparse autoencoder on
MNIST: net [784, 400, 100, 300, 784], ReLU hiddens, a linear output, the
embedding = the layer-2 pre-activation (``answer`` = hidden1 @ w2 + b2,
``SDNE.py:95,170-172``), and the loss

    mean(l2_loss(y - y_) / minibatch)                     (SDNE.py:104)
  + 1e-1 * sum l2_loss(all W, b)                          (SDNE.py:106-109)
  + 1e-1 * KL(p1=0.005 || mean(relu(hidden2)))            (SDNE.py:112-122)

with tf.l2_loss(x) = sum(x^2)/2, Adam lr 0.01, minibatches of 100 taken in
order, 200k steps.  The same constants and reductions here, so the named
activations compare with graphtpu's and with the reference's formulas.
Given the same initial parameters a run is deterministic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graphtpu_torch.core.config import SDNEConfig
from graphtpu_torch.core.device import full_fp32, resolve_device
from graphtpu_torch.core.prng import generator, key_for

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def init_params(cfg: SDNEConfig, key: int, device) -> Params:
    """0.1 x a normal truncated at 2 standard deviations for each weight,
    zero biases (``SDNE.py:74-84``)."""
    gen = generator(key, device)
    params = []
    for fan_in, fan_out in zip(cfg.units[:-1], cfg.units[1:]):
        w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=device)
        w = 0.1 * nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=gen)
        params.append((w, torch.zeros(fan_out, device=device)))
    return params


def params_from_numpy(params: Sequence[Tuple[np.ndarray, np.ndarray]], device) -> Params:
    """[(w, b), ...] as float32 tensors on ``device``: graphtpu's
    ``init_params`` or trained parameters."""
    return [tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                  for a in pair) for pair in params]


def forward(params: Params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's named tensors."""
    (w1, b1), (w2, b2), (w3, b3), (w4, b4) = params
    hidden1 = F.relu(x @ w1 + b1)
    answer = hidden1 @ w2 + b2            # the embedding (pre-activation)
    hidden2 = F.relu(answer)
    hidden3 = F.relu(hidden2 @ w3 + b3)
    y = hidden3 @ w4 + b4                 # linear output
    return {"hidden1": hidden1, "answer": answer, "hidden2": hidden2,
            "hidden3": hidden3, "y": y}


def _l2(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x)) / 2.0  # tf.nn.l2_loss


def loss_fn(params: Params, x: torch.Tensor, cfg: SDNEConfig):
    """(total, {"recon", "reg1", "reg2"})."""
    acts = forward(params, x)
    recon = _l2(acts["y"] - x) / (1.0 * cfg.minibatch)
    reg1 = sum(_l2(w) + _l2(b) for (w, b) in params)
    p1 = cfg.sparsity_p
    sumq = torch.mean(acts["hidden2"])
    reg2 = p1 * torch.log(p1 / (sumq + 1e-8)) + (1.0 - p1) * torch.log(
        (1.0 - p1) / (1.0 - sumq + 1e-8))
    total = recon + cfg.l2_coeff * reg1 + cfg.kl_coeff * reg2
    return total, {"recon": recon, "reg1": reg1, "reg2": reg2}


class Trainer:
    """One run's state on one device: a copy of ``params`` as leaves, Adam,
    and the rows of ``x_train``, taken as minibatches in order."""

    def __init__(self, x_train, params: Params, cfg: SDNEConfig, device):
        self.cfg = cfg
        self.leaves = [p.detach().clone().to(device).requires_grad_()
                       for pair in params for p in pair]
        self.params = list(zip(self.leaves[0::2], self.leaves[1::2]))
        self.opt = torch.optim.Adam(self.leaves, lr=cfg.learning_rate)
        self.x = torch.as_tensor(x_train, dtype=torch.float32).to(device)
        self.mb = min(cfg.minibatch, self.x.shape[0])
        self.nb = max(self.x.shape[0] // self.mb, 1)
        self.i = 0

    def step(self):
        """One Adam step on minibatch i mod nb (rows from (i mod nb) * mb);
        returns (total, terms) as ``loss_fn`` does.  Call inside
        ``full_fp32()``."""
        start = (self.i % self.nb) * self.mb
        total, terms = loss_fn(self.params, self.x[start:start + self.mb], self.cfg)
        self.opt.zero_grad()
        total.backward()
        self.opt.step()
        self.i += 1
        return total.detach(), terms


def train_sdne(
    x_train,
    cfg: SDNEConfig = SDNEConfig(),
    steps: Optional[int] = None,
    log_every: int = 0,
    params: Optional[Params] = None,
    device=None,
):
    """Train on ``device`` (default ``cuda``) from ``params`` (default:
    :func:`init_params` on ``key_for(cfg.seed, 0)``); step i takes the
    minibatch starting at row (i mod nb) * mb.  Returns (params, embed),
    embed(x) = the layer-2 pre-activation (the reference's ``answer``) as
    numpy."""
    dev = resolve_device(device)
    steps = cfg.steps if steps is None else steps
    if params is None:
        params = init_params(cfg, key_for(cfg.seed, 0), dev)
    trainer = Trainer(x_train, params, cfg, dev)
    with full_fp32():
        for i in range(steps):
            total, terms = trainer.step()
            if log_every and i % log_every == 0:
                print(f"step {i}, loss {total.item():g}, recon {terms['recon'].item():g}, "
                      f"reg1 {terms['reg1'].item():g}, reg2 {terms['reg2'].item():g}")
    params = [(w.detach(), b.detach()) for w, b in trainer.params]

    def embed(x) -> np.ndarray:
        with torch.no_grad(), full_fp32():
            xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
            return forward(params, xt)["answer"].cpu().numpy()

    return params, embed
