"""Data-parallel SGNS training, the replacement for the reference's hogwild
threads (counterpart of ``graphtpu/dist/sgns_dp.py``).

The reference trains SGNS with 8 asynchronous hogwild threads inside
gensim (``node2vec/src/main.py:97``).  Here training is synchronous data
parallelism over a mesh's ``data`` axis: each rank steps on its share of
the pair batch and the row gradients are summed over the axis (one
all-reduce a step), so every rank holds the same tables.  graphtpu also
row-shards the [V, D] tables over a ``model`` axis; that axis is not
ported (a mesh with a ``model`` axis of more than one rank raises), since
one card holds the tables whole at every shape of the repository.
"""

from __future__ import annotations

import torch

from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.core.device import full_fp32
from graphtpu_torch.dist.frontier import _local_rows
from graphtpu_torch.models.sgns import sgns_step


def _data_axis(mesh):
    if len(mesh.shape) > 1 and mesh.shape[1] > 1:
        raise NotImplementedError(
            f"SGNS runs the data axis only; a '{mesh.axis_names[1]}' axis of {mesh.shape[1]} "
            "ranks (row-sharded tables) is ROADMAP item 14")
    return mesh.axis_names[0]


def train_sgns_dp(walks, n_nodes: int, mesh, cfg: SGNSConfig = SGNSConfig(), **kw):
    """The whole training run (epochs, dynamic windows, subsampling, linear
    LR, checkpoint/resume) data-parallel over ``mesh``: a thin entry over
    :func:`graphtpu_torch.models.sgns.train_sgns` with ``mesh`` set, given
    the whole walk tensor on every rank.  Returns (syn0, syn1) numpy [V, D]
    on every rank; a ``model`` axis of more than one rank raises
    NotImplementedError."""
    from graphtpu_torch.models.sgns import train_sgns

    return train_sgns(walks, n_nodes, cfg, mesh=mesh, **kw)


def make_sgns_train_step(mesh, cfg: SGNSConfig, n_nodes: int):
    """Returns (shard_params, shard_batch, train_step).

    ``shard_params((syn0, syn1))`` puts the tables on this rank's device
    (whole: the data axis replicates them); ``shard_batch(centers,
    contexts, mask, negs)`` takes this rank's row block of a global batch
    (``centers [B]``, ``contexts [B, 2w]``, ``mask [B, 2w]``, ``negs
    [B, 2w, N]`` or ``[B, N]``); ``train_step(params, centers, contexts,
    mask, negs, lr)`` runs one synchronous SGD step on the rank's block,
    the gradients summed over the data axis."""
    axis = _data_axis(mesh)
    n, me, group, dev = mesh.axis_size(axis), mesh.axis_index(axis), mesh.groups[axis], mesh.device

    def shard_params(params):
        return tuple(torch.as_tensor(p, dtype=torch.float32).to(dev) for p in params)

    def shard_batch(centers, contexts, mask, negs):
        b = centers.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} ranks")
        per = b // n
        return (_local_rows(centers, me, per, dev), _local_rows(contexts, me, per, dev),
                torch.as_tensor(mask)[me * per: (me + 1) * per].to(device=dev, dtype=torch.bool),
                _local_rows(negs, me, per, dev))

    def train_step(params, centers, contexts, mask, negs, lr):
        with full_fp32():
            return sgns_step(params, centers, contexts, mask, negs, lr, n_nodes,
                             data_group=group)

    return shard_params, shard_batch, train_step
