"""Sharded SGNS training, the replacement for the reference's hogwild threads
(counterpart of ``graphtpu/dist/sgns_dp.py``).

The reference trains SGNS with 8 asynchronous hogwild threads inside
gensim (``node2vec/src/main.py:97``).  Here training is synchronous over a
(data, model) mesh, as in graphtpu: the pair batch is split over ``data``
and both [V, D] tables are row-sharded over ``model``.  Rank (i, j) steps
on data block i and holds rows [j·R, (j+1)·R) of each table, R = ⌈V/m⌉
(the last block padded with rows no id reaches).  A step
(:func:`sharded_sgns_step`) needs no all-to-all and its lookups are exact:

1. the block's ids per table (centers for syn0; contexts and negatives
   for syn1) reduced to sorted unique ids; the m ranks of a data row hold
   the same block, hence the same ids;
2. lookup: each rank writes the rows it owns into a zero [U, D] buffer
   and the buffer is summed over ``model`` (one ``psum``): one rank adds
   a non-zero value to any element, so the rows are the table's bits;
3. the closed-form gradients on those rows, summed per unique id by
   :func:`~graphtpu_torch.kernels.topk.segment_rows_sum` (the ranks of a
   data row repeat this compute, the price of asking nothing of anyone);
4. update: with one data block, each rank moves its owned rows in place;
   with more, each writes its owned rows' sums and counts into a zero
   [R, 2D+2] buffer summed over ``data`` (one ``psum``) and moves its
   shard by it.

Every row moves by its gradient summed over the global batch over its
count there (the collision normalisation of
:func:`graphtpu_torch.models.sgns.sgns_step`), so a (d, m) run follows the
single-device trajectory but for the order of the sums; with d = 1 the
order is one device's and the tables are its bits.  Per step a rank puts
(U0 + U1)·D·4 bytes into the model all-reduce (m > 1) and R·(2D+2)·4
into the data one (d > 1).  No rank of a model axis larger than one ever
holds a whole table or a whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.core.device import full_fp32
from graphtpu_torch.dist.frontier import _local_rows
from graphtpu_torch.dist.mesh import all_gather, psum
from graphtpu_torch.kernels.topk import segment_rows_sum
from graphtpu_torch.models.sgns import sgns_closed_form
from graphtpu_torch.utils.metrics import StageClock

GATHER_ROWS = 1 << 16  # rows per all-gather when tables are assembled on the host


@dataclasses.dataclass(frozen=True)
class RowShards:
    """How a (data, model) mesh splits SGNS on this rank: the pair batch in
    ``n_blocks`` blocks over ``data`` (this rank steps on block ``block``),
    each table's ``n_nodes`` rows in ``n_model`` blocks of ``rows`` over
    ``model`` (this rank holds rows [lo, lo + rows))."""

    n_nodes: int
    rows: int
    lo: int
    block: int
    n_blocks: int
    n_model: int
    data_group: Any
    model_group: Any
    device: torch.device


def row_shards(mesh, n_nodes: int) -> RowShards:
    """This rank's :class:`RowShards` on ``mesh``: its first axis is the
    data axis, its second (if any) the model axis."""
    data = mesh.axis_names[0]
    model = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    m = mesh.axis_size(model) if model else 1
    rows = -(-n_nodes // m)
    return RowShards(n_nodes=n_nodes, rows=rows,
                     lo=(mesh.axis_index(model) if model else 0) * rows,
                     block=mesh.axis_index(data), n_blocks=mesh.axis_size(data), n_model=m,
                     data_group=mesh.groups[data], model_group=mesh.groups.get(model),
                     device=mesh.device)


def take_rows(table, shards: RowShards) -> torch.Tensor:
    """This rank's [rows, D] float32 block of a [V, D] table (numpy, a
    memmap or a tensor) on its device; only rows [lo, lo + rows) are read,
    and the padding past V is 0.  Always a copy: the step updates it in
    place."""
    part = table[shards.lo: min(shards.lo + shards.rows, shards.n_nodes)]
    part = (part.to(shards.device, torch.float32, copy=True) if isinstance(part, torch.Tensor)
            else torch.from_numpy(np.array(part, np.float32)).to(shards.device))
    pad = shards.rows - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_zeros((pad, part.shape[1]))])
    return part


def _owned(ids: torch.Tensor, shards: RowShards):
    """(local row of each id, whether this rank owns it)."""
    local = ids - shards.lo
    return local, (local >= 0) & (local < shards.rows)


def _owned_rows(shard: torch.Tensor, ids: torch.Tensor, shards: RowShards) -> torch.Tensor:
    """[len(ids), D]: the rows of ``ids`` this rank owns, 0 elsewhere."""
    local, own = _owned(ids, shards)
    return torch.where(own[:, None], shard[local.clamp(0, shards.rows - 1)], 0.0)


def lookup_rows(pairs, shards: RowShards):
    """The rows of each ``(shard, ids)`` pair's table at ``ids``, as one
    ``[len(ids), D]`` tensor per pair: every rank writes the rows it owns
    into zeros and one psum over the model group joins them.  Exact: at
    every element one rank adds its value to zeros."""
    rows = torch.cat([_owned_rows(shard, ids, shards) for shard, ids in pairs])
    if shards.n_model > 1:
        rows = psum(rows, shards.model_group)
    return rows.split([len(ids) for _, ids in pairs])


def sharded_sgns_step(
    params: Tuple[torch.Tensor, torch.Tensor],
    centers: torch.Tensor,
    contexts: torch.Tensor,
    mask: torch.Tensor,
    negs: torch.Tensor,
    lr: float,
    shards: RowShards,
    stage_times: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One synchronous SGD step on this rank's data block (``centers [b]``,
    ``contexts``/``mask [b, 2w]``, ``negs [b, 2w, N]`` or ``[b, N]``) with
    its row shards ``params`` (syn0, syn1), each [rows, D]; the shards are
    updated in place (graphtpu donates them) and returned.  See the module
    docstring for the steps.  ``stage_times``: ms of "lookup", "compute"
    and "update" (:class:`~graphtpu_torch.utils.metrics.StageClock`, the device
    synchronised around each) and the bytes this rank puts into the
    all-reduces, "lookup_bytes" and "update_bytes", are added to it."""
    stages = StageClock(stage_times, shards.device, sync=True)
    syn0, syn1 = params
    d = syn0.shape[1]
    nc = contexts.numel()

    def lookup():
        u0, inv0 = torch.unique(centers.clamp(min=0), return_inverse=True)
        u1, inv1 = torch.unique(torch.cat([contexts.clamp(min=0).reshape(-1), negs.reshape(-1)]),
                                return_inverse=True)
        return u0, inv0, u1, inv1, lookup_rows([(syn0, u0), (syn1, u1)], shards)

    def compute():
        ictx, ineg = inv1[:nc].view(contexts.shape), inv1[nc:].view(negs.shape)
        dv, du, dun = sgns_closed_form(l0[inv0], l1[ictx], l1[ineg], centers, contexts, mask, negs)
        # sorted unique ids keep each row's summands in one device's order
        g0, c0 = segment_rows_sum(torch.where(centers >= 0, inv0, -1), dv, len(u0))
        idx1 = torch.cat([torch.where(mask, ictx, -1).reshape(-1), ineg.reshape(-1)])
        g1, c1 = segment_rows_sum(idx1, torch.cat([du.reshape(-1, d), dun.reshape(-1, d)]),
                                  len(u1))
        return g0, c0, g1, c1

    def update():
        (at0, own0), (at1, own1) = _owned(u0, shards), _owned(u1, shards)
        if shards.n_blocks == 1:
            for shard, local, own, g, c in ((syn0, at0, own0, g0, c0), (syn1, at1, own1, g1, c1)):
                at = local[own]
                shard[at] = shard[at] - lr * (g[own] / c[own].clamp(min=1)[:, None])
            return 0
        buf = syn0.new_zeros((shards.rows, 2 * d + 2))
        buf[at0[own0], : d + 1] = torch.cat([g0, c0[:, None]], dim=1)[own0]
        buf[at1[own1], d + 1:] = torch.cat([g1, c1[:, None]], dim=1)[own1]
        buf = psum(buf, shards.data_group)
        syn0.sub_(lr * (buf[:, :d] / buf[:, d].clamp(min=1)[:, None]))
        syn1.sub_(lr * (buf[:, d + 1: 2 * d + 1] / buf[:, 2 * d + 1].clamp(min=1)[:, None]))
        return buf.numel() * buf.element_size()

    u0, inv0, u1, inv1, (l0, l1) = stages.stage("lookup", lookup)
    g0, c0, g1, c1 = stages.stage("compute", compute)
    update_bytes = stages.stage("update", update)
    if stage_times is not None:
        lookup_bytes = (len(u0) + len(u1)) * d * syn0.element_size() if shards.n_model > 1 else 0
        stage_times["lookup_bytes"] = stage_times.get("lookup_bytes", 0) + lookup_bytes
        stage_times["update_bytes"] = stage_times.get("update_bytes", 0) + update_bytes
    return syn0, syn1


def gather_params(params, mesh, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """The whole [V, D] tables as host numpy, assembled from the shards of
    this rank's model group (every rank of the group calls it).  The rows
    go through the device ``GATHER_ROWS`` per shard at a time, so no whole
    table is ever on the device."""
    shards = row_shards(mesh, n_nodes)
    out = []
    for shard in params:
        whole = np.empty((shards.n_model * shards.rows, shard.shape[1]), np.float32)
        for a in range(0, shards.rows, GATHER_ROWS):
            part = shard[a: a + GATHER_ROWS]
            got = (all_gather(part, shards.model_group) if shards.n_model > 1
                   else part[None]).cpu().numpy()
            for k in range(shards.n_model):
                whole[k * shards.rows + a: k * shards.rows + a + part.shape[0]] = got[k]
        out.append(whole[:n_nodes])
    return out[0], out[1]


def train_sgns_dp(walks, n_nodes: int, mesh, cfg: SGNSConfig = SGNSConfig(), **kw):
    """The whole training run (epochs, dynamic windows, subsampling, linear
    LR, checkpoint/resume) over ``mesh``: a thin entry over
    :func:`graphtpu_torch.models.sgns.train_sgns` with ``mesh`` set, given
    the whole walk tensor on every rank.  Returns (syn0, syn1) numpy [V, D]
    on every rank."""
    from graphtpu_torch.models.sgns import train_sgns

    return train_sgns(walks, n_nodes, cfg, mesh=mesh, **kw)


def make_sgns_train_step(mesh, cfg: SGNSConfig, n_nodes: int):
    """Returns (shard_params, shard_batch, train_step).

    ``shard_params((syn0, syn1))`` copies this rank's row block of each
    [V, D] table (numpy, a memmap or a tensor; only those rows are read) to
    its device; ``shard_batch(centers, contexts, mask, negs)`` takes this
    rank's data block of a global batch (``centers [B]``, ``contexts
    [B, 2w]``, ``mask [B, 2w]``, ``negs [B, 2w, N]`` or ``[B, N]``);
    ``train_step(params, centers, contexts, mask, negs, lr,
    stage_times=None)`` runs :func:`sharded_sgns_step` and returns the
    rank's shards.  :func:`gather_params` assembles the whole tables."""
    shards = row_shards(mesh, n_nodes)
    n, me, dev = shards.n_blocks, shards.block, shards.device

    def shard_params(params):
        return tuple(take_rows(p, shards) for p in params)

    def shard_batch(centers, contexts, mask, negs):
        b = centers.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} ranks")
        per = b // n
        return (_local_rows(centers, me, per, dev), _local_rows(contexts, me, per, dev),
                torch.as_tensor(mask)[me * per: (me + 1) * per].to(device=dev, dtype=torch.bool),
                _local_rows(negs, me, per, dev))

    def train_step(params, centers, contexts, mask, negs, lr, stage_times=None):
        with full_fp32():
            return sharded_sgns_step(params, centers, contexts, mask, negs, lr, shards,
                                     stage_times)

    return shard_params, shard_batch, train_step
