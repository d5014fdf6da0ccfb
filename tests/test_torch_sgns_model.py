"""SGNS's model axis (tables row-sharded over ``model``) and the dense
SimRank forms' ``matmul_precision``, against graphtpu and against the
port's own single-device path.

The port's meshes run in 4 gloo ranks on the CPU, spawned once for the
module (graphtpu_torch.dist.mesh.spawn); every rank runs :func:`_rank_cases`
and rank 0 returns what the tests check.  graphtpu runs here on the
virtual 8-device CPU mesh of tests/conftest.py.  The ranks import this
module, so jax and graphtpu are imported inside the tests only.

Tolerances: one step on a (2, 2) or (1, 4) mesh within 1e-5 of graphtpu's
step on its (4, 2) mesh (test_torch_dist.py's bar for the data axis); the
lookups and the shards exact; a whole run within 1e-5 of one device on
(2, 2) (the data axis sums each row's gradient in two blocks) and 1e-6 on
(1, 4) (one device's order of sums: predicted equal); a run resumed on
another mesh shape, or on one device, within 1e-6 of the uninterrupted
run; the dense forms within 1e-6 of graphtpu's at every precision name
(on the CPU both compute full float32 whatever the name).
"""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphtpu_torch import build_graph
from graphtpu_torch.core.config import SGNSConfig, SimRankConfig, TopSimConfig
from graphtpu_torch.dist import mesh as tm
from test_torch_dist import N_RANKS, SGNS_CFG, sgns_step_inputs, sgns_walks, small_edges

torch.set_num_threads(1)
MESHES = {"2x2": 2, "1x4": 4}   # name -> model_parallel over the 4 ranks
STEP_CFG = SGNSConfig(dim=16, window=2, negative=3)
PRECISIONS = ("default", "high", "highest", "bfloat16", "tensorfloat32", "float32")
CHUNK = 5                       # steps per chunk of the resumed runs (a checkpoint each)
GUARD_V, GUARD_D = 4096, 8      # the table no rank may hold whole
SHARD_VS = (64, 50, 3)
TOL_STEP = 1e-5
TOL_RUN = {"2x2": 1e-5, "1x4": 1e-6}
TOL_RESUME = 1e-6
TOL_DENSE = 1e-6


def step_batch(shared):
    si = sgns_step_inputs()
    negs = si["negs"][:, 0, :] if shared else si["negs"]
    return si, (si["centers"], si["contexts"], si["mask"], negs)


class RowGuard:
    """A [V, D] table that raises when rows outside [lo, hi) are read."""

    def __init__(self, a, lo, hi):
        self.a, self.lo, self.hi = a, lo, hi

    def __getitem__(self, key):
        if not (isinstance(key, slice) and self.lo <= key.start and key.stop <= self.hi):
            raise IndexError(f"read {key} outside the rank's rows [{self.lo}, {self.hi})")
        return self.a[key]


def _largest_allocation(fn):
    """(fn's result, the largest numel of any tensor an aten op made in it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Watch(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Watch.largest = max(Watch.largest, t.numel())
            return out

    with Watch():
        res = fn()
    return res, Watch.largest


# ---------------------------------------------------------------------------
# what every rank runs


def _rank_cases(device, tmp):
    import torch.distributed as dist

    from graphtpu_torch.dist.sgns_dp import (
        gather_params,
        lookup_rows,
        make_sgns_train_step,
        row_shards,
        take_rows,
        train_sgns_dp,
    )
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.dist.spmm_sharded import gather_sim
    from graphtpu_torch.models import checkpoint as ckpt_mod

    out = {}
    world = tm.make_1d_mesh(device=device)
    wgrp = world.groups["data"]
    walks = sgns_walks()
    for name, mp in MESHES.items():
        mesh = tm.make_mesh(model_parallel=mp, device=device)
        out[f"coords_{name}"] = tm.all_gather(torch.tensor(mesh.coords), wgrp).numpy()
        # one step, per-pair and shared negatives
        for shared in (False, True):
            si, batch = step_batch(shared)
            shard_params, shard_batch, train_step = make_sgns_train_step(mesh, STEP_CFG, si["v"])
            params = train_step(shard_params((si["p0"], si["p1"])), *shard_batch(*batch), 0.05)
            out[f"step_{name}_{shared}"] = gather_params(params, mesh, si["v"])
        # the lookup: seeded sorted ids (the ranks of a data row share them)
        shards = row_shards(mesh, 64)
        table = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32)
        ids = torch.from_numpy(np.sort(np.random.default_rng(6 + mesh.coords[0])
                                       .permutation(64)[:40]))
        (rows,) = lookup_rows([(take_rows(table, shards), ids)], shards)
        out[f"lookup_{name}"] = tm.all_gather(torch.cat([ids[:, None].float(), rows], 1),
                                              wgrp).numpy()
        # the shards, at V = 64, V = 50 (the last block padded) and V = 3
        # (at (1, 4), rank 3's block lies past V)
        for v in SHARD_VS:
            whole = np.arange(v * 3, dtype=np.float32).reshape(v, 3) + 1
            sh = row_shards(mesh, v)
            part = take_rows(whole, sh)
            back = gather_params((part, part), mesh, v)[0]
            out[f"shards_{name}_{v}"] = (tm.all_gather(part, wgrp).numpy(),
                                         tm.all_gather(torch.from_numpy(back), wgrp).numpy())
        # a whole run
        out[f"run_{name}"] = train_sgns_dp(walks, 64, mesh, SGNS_CFG)

    # a (2, 2) run with a checkpoint each chunk; its first one kept (mid-run)
    m22 = tm.make_mesh(model_parallel=2, device=device)
    ck, snap = os.path.join(tmp, "sgns.ckpt"), os.path.join(tmp, "snap.ckpt")
    saves = {"n": 0}
    orig_save = ckpt_mod.save_state

    def snapping_save(path, arrays, step=0, meta=None):
        orig_save(path, arrays, step=step, meta=meta)
        saves["n"] += 1
        if saves["n"] == 2:
            shutil.copy(path, snap)

    ckpt_mod.save_state = snapping_save
    try:
        out["full_2x2"] = train_sgns_dp(walks, 64, m22, SGNS_CFG, chunk_steps=CHUNK,
                                        checkpoint_path=ck, checkpoint_every=1)
    finally:
        ckpt_mod.save_state = orig_save
    dist.barrier()
    if world.rank == 0:
        shutil.copy(snap, ck)  # rewind to mid-run
    dist.barrier()
    out["resumed_1x4"] = train_sgns_dp(walks, 64, tm.make_mesh(model_parallel=4, device=device),
                                       SGNS_CFG, chunk_steps=CHUNK, checkpoint_path=ck)
    out["snapshot"] = snap

    # no whole table: (1, 4), a guarded V = 4096 table, one step
    m14 = tm.make_mesh(model_parallel=4, device=device)
    sh = row_shards(m14, GUARD_V)
    table = np.random.default_rng(7).normal(size=(GUARD_V, GUARD_D)).astype(np.float32)
    guard = RowGuard(table, sh.lo, sh.lo + sh.rows)
    shard_params, shard_batch, train_step = make_sgns_train_step(
        m14, SGNSConfig(dim=GUARD_D, window=2, negative=3), GUARD_V)
    rng = np.random.default_rng(8)
    b = 16
    batch = shard_batch(rng.integers(0, GUARD_V, b), rng.integers(0, GUARD_V, (b, 4)),
                        np.ones((b, 4), bool), rng.integers(0, GUARD_V, (b, 3)))
    params, made0 = _largest_allocation(lambda: shard_params((guard, guard)))
    params, made1 = _largest_allocation(lambda: train_step(params, *batch, 0.05))
    out["guard"] = tm.all_gather(torch.tensor([sh.rows, *params[0].shape, *params[1].shape,
                                               made0, made1]), wgrp).numpy()

    # the dense sharded form at each precision name, and an unknown name
    small = build_graph(small_edges(), n_nodes=64)
    cfg = SimRankConfig(iterations=3)
    for name in PRECISIONS:
        out[f"sharded_{name}"] = gather_sim(sharded_exact_simrank(small, world, cfg,
                                                                  matmul_precision=name)).numpy()
    try:
        sharded_exact_simrank(small, world, cfg, matmul_precision="medium")
        out["sharded_unknown"] = None
    except ValueError as e:
        out["sharded_unknown"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tm.spawn(_rank_cases, N_RANKS, "gloo", "cpu",
                    args=(str(tmp_path_factory.mktemp("ranks")),), timeout=600)


@pytest.fixture(scope="module")
def gt():
    import jax.numpy as jnp

    import graphtpu
    from graphtpu.core import config as jc
    from graphtpu.dist import mesh, sgns_dp, simrank_sharded
    from graphtpu.simrank import exact, meeting

    return SimpleNamespace(jnp=jnp, graphtpu=graphtpu, config=jc, mesh=mesh, sgns_dp=sgns_dp,
                           simrank_sharded=simrank_sharded, exact=exact, meeting=meeting)


def single_device(**kw):
    from graphtpu_torch.models.sgns import train_sgns

    return train_sgns(sgns_walks(), 64, SGNS_CFG, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the model axis


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
@pytest.mark.parametrize("name", list(MESHES))
def test_step_equals_graphtpu(gt, ranks, name, shared):
    """One step on a (2, 2) and a (1, 4) mesh against graphtpu's step on
    its (4, 2) mesh (tables row-sharded over 'model', batch over 'data')."""
    jnp = gt.jnp
    si, batch = step_batch(shared)
    mesh = gt.mesh.make_mesh(8, model_parallel=2)
    shard_params, _, train_step = gt.sgns_dp.make_sgns_train_step(
        mesh, gt.config.SGNSConfig(dim=16, window=2, negative=3), si["v"])
    # graphtpu's shard_batch places 3-D negatives only; its step takes any
    want = train_step(shard_params((jnp.asarray(si["p0"]), jnp.asarray(si["p1"]))),
                      *(jnp.asarray(x) for x in batch), 0.05)
    got = ranks[f"step_{name}_{shared}"]
    for a, b in zip(got, want):
        assert a.shape == (si["v"], 16)
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL_STEP)
    assert not np.array_equal(got[0], si["p0"])


@pytest.mark.parametrize("name", list(MESHES))
def test_lookup_is_the_tables_bits(ranks, name):
    table = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32)
    per_rank = ranks[f"lookup_{name}"]
    for r in range(N_RANKS):
        ids, rows = per_rank[r][:, 0].astype(np.int64), per_rank[r][:, 1:]
        np.testing.assert_array_equal(rows, table[ids])


@pytest.mark.parametrize("v", SHARD_VS)
def test_shards_are_row_blocks(ranks, v):
    whole = np.arange(v * 3, dtype=np.float32).reshape(v, 3) + 1
    for name, m in MESHES.items():
        rows = -(-v // m)
        parts, backs = ranks[f"shards_{name}_{v}"]
        coords = ranks[f"coords_{name}"]
        for r in range(N_RANKS):
            j = coords[r][1]
            want = np.zeros((rows, 3), np.float32)
            block = whole[j * rows: (j + 1) * rows]
            want[: len(block)] = block
            np.testing.assert_array_equal(parts[r], want, err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(backs[r], whole, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", list(MESHES))
def test_train_equals_single_device(ranks, name):
    s0, s1 = single_device()
    d0, d1 = ranks[f"run_{name}"]
    err = max(np.abs(d0 - s0).max(), np.abs(d1 - s1).max())
    print(f"{name}: largest difference from one device {err:.3e}")
    assert err <= TOL_RUN[name], err
    assert np.isfinite(d0).all() and not np.allclose(d0, 0)


@pytest.mark.parametrize("lo,rows,v", [(0, 70_000, 70_000), (65_000, 1_000, 70_000),
                                       (69_990, 20, 70_000), (70_004, 2, 70_000)])
def test_init_rows_are_the_whole_tables_rows(lo, rows, v):
    """syn0's init drawn for a row block (across a chunk boundary, past V)
    equals those rows of the whole table, one device's draw."""
    from graphtpu_torch.models.sgns import init_syn0

    whole = init_syn0(7, 0, v, v, 2, "cpu")
    want = torch.zeros((rows, 2))
    n = max(0, min(rows, v - lo))
    want[:n] = whole[lo: lo + n]
    assert torch.equal(init_syn0(7, lo, rows, v, 2, "cpu"), want)


@pytest.mark.parametrize("on", ["1x4", "single"])
def test_resume_across_shapes(ranks, tmp_path, on):
    """The (2, 2) run's mid-run checkpoint resumed on (1, 4) and on one
    device lands on the uninterrupted (2, 2) run."""
    if on == "1x4":
        got = ranks["resumed_1x4"]
    else:
        path = str(tmp_path / "ck.npz")
        shutil.copy(ranks["snapshot"], path)
        got = single_device(chunk_steps=CHUNK, checkpoint_path=path)
    for a, b in zip(got, ranks["full_2x2"]):
        np.testing.assert_allclose(a, b, atol=TOL_RESUME)


def test_no_whole_table_on_a_rank(ranks):
    """(1, 4) at V = 4096: shard_params reads only the rank's rows of a
    guarded table, and neither it nor a step makes a tensor as large as a
    whole table."""
    for r, (rows, a0, a1, b0, b1, made0, made1) in enumerate(ranks["guard"]):
        assert rows == GUARD_V // 4
        assert (a0, a1, b0, b1) == (rows, GUARD_D, rows, GUARD_D), r
        assert made0 < GUARD_V * GUARD_D and 0 < made1 < GUARD_V * GUARD_D, (r, made0, made1)


# ---------------------------------------------------------------------------
# matmul_precision on the dense forms


def _port_dense(form, name):
    from graphtpu_torch.simrank.exact import exact_simrank
    from graphtpu_torch.simrank.meeting import doublesample_similarity

    g = build_graph(small_edges(), n_nodes=64)
    if form == "exact":
        return exact_simrank(g, SimRankConfig(iterations=3), matmul_precision=name,
                             device="cpu").numpy()
    return doublesample_similarity(g, TopSimConfig(step=3), matmul_precision=name, device="cpu")


def _graphtpu_dense(gt, form, name):
    jg = gt.graphtpu.build_graph(small_edges(), n_nodes=64)
    if form == "exact":
        return np.asarray(gt.exact.exact_simrank(jg, gt.config.SimRankConfig(iterations=3),
                                                 matmul_precision=name))
    if form == "doublesample":
        return gt.meeting.doublesample_similarity(jg, gt.config.TopSimConfig(step=3),
                                                  matmul_precision=name)
    return np.asarray(gt.simrank_sharded.sharded_exact_simrank(
        jg, gt.mesh.make_1d_mesh(N_RANKS), gt.config.SimRankConfig(iterations=3),
        matmul_precision=name))


@pytest.mark.parametrize("name", PRECISIONS)
@pytest.mark.parametrize("form", ["exact", "doublesample", "sharded"])
def test_matmul_precision_equals_graphtpu(gt, ranks, form, name):
    got = ranks[f"sharded_{name}"] if form == "sharded" else _port_dense(form, name)
    np.testing.assert_allclose(got, _graphtpu_dense(gt, form, name), atol=TOL_DENSE)


@pytest.mark.parametrize("form", ["exact", "doublesample", "sharded"])
def test_unknown_matmul_precision_raises(gt, ranks, form):
    with pytest.raises(ValueError):
        _graphtpu_dense(gt, form, "medium")
    if form == "sharded":
        assert ranks["sharded_unknown"] is not None and "medium" in ranks["sharded_unknown"]
    else:
        with pytest.raises(ValueError, match="medium"):
            _port_dense(form, "medium")
