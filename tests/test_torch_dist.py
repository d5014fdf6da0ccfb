"""graphtpu_torch.dist against graphtpu.dist.

graphtpu runs its shard_map programs on the virtual 8-device CPU mesh of
tests/conftest.py (4 devices where the port runs 4 ranks).  The port runs
in 4 gloo ranks on the CPU, spawned once for the module by
graphtpu_torch.dist.mesh.spawn: every rank runs every case of
:func:`_rank_cases` and rank 0 returns the gathered results, which the tests
hold against graphtpu run here on the same inputs (numpy-seeded graphs).

The spawned ranks import this module to find :func:`_rank_cases`, so jax
and graphtpu are imported inside the tests (the ``gt`` fixture), never at
the top.

Tolerances: the plans, the shards, the routing and the packed exchanges
are compared exactly; the ring's and SUMMA's float32 scores at 1e-6
against graphtpu's (the same float32 operations, the sums of SUMMA's
partials in another order) and 1e-5 against the dense fp32 engine; bf16
iterates within BF16_ULPS = 3 bf16 ulps of graphtpu's at each entry (the
first iteration is bit-equal; the products accumulate in float32 in the
same order, but XLA's CPU code fuses a multiply and an add into one
rounding where PyTorch rounds twice, so a float32 sum one ulp apart can
round to the neighbouring bf16 value, and the next iteration's products
read it: 2 ulps at most after 3 iterations on these graphs); the walks as
graphtpu's tests hold them (every transition an edge, sharded runs equal
to replicated ones under one seed), the node2vec joint (hop1, hop2)
distribution within total variation 0.02 of the exact transition
probabilities over 200,000 walkers; the Monte-Carlo engines at graphtpu's
test thresholds (tests/test_dist.py); SGNS steps at 1e-5.
"""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphtpu_torch import build_graph
from graphtpu_torch.core.config import SGNSConfig, SimRankConfig, TopSimConfig, UniWalkConfig
from graphtpu_torch.dist import frontier as tf
from graphtpu_torch.dist import mesh as tm
from graphtpu_torch.dist.sharded_graph import shard_arrays, shard_graph
from graphtpu_torch.dist.spmm_sharded import build_sharded_tree_plan
from graphtpu_torch.simrank.exact import exact_simrank
from graphtpu_torch.walks.node2vec import node2vec_transition_probs

torch.set_num_threads(1)
N_RANKS = 4
TOL_F32 = 1e-6
TOL_DENSE = 1e-5
N2V_WALKERS = 200_000
N2V_TV = 0.02
BF16_ULPS = 3


# ---------------------------------------------------------------------------
# inputs, built the same way in the ranks and in the tests


def ring_edges(v):
    return np.stack([np.arange(v), (np.arange(v) + 1) % v], 1)


def random_edges(v, e, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    return np.concatenate([edges[edges[:, 0] != edges[:, 1]], ring_edges(v)])


def small_edges():
    """tests/conftest.py's ``small_random``: 64 nodes, no isolated node."""
    return random_edges(64, 400, 42)


def medium_edges():
    """tests/test_dist.py's ``_medium_random``: 256 nodes."""
    return random_edges(256, 2048, 3)


def weighted_int_graph_inputs():
    """64 nodes with integer weights (exact float32 row sums)."""
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 64, size=(300, 2))
    edges = np.concatenate([edges[edges[:, 0] != edges[:, 1]], ring_edges(64)])
    return edges, rng.integers(1, 5, size=len(edges)).astype(np.float32)


def n2v_edges():
    return random_edges(48, 220, 4)


def sparse_edges():
    """deg ~ 3: the deterministic TopSim split tree fits every bucket."""
    return random_edges(64, 100, 8)


def bf16_edges():
    """tests/test_spmm_scaling.py's bf16 graph: 256 nodes."""
    return random_edges(256, 2000, 1)


def sgns_step_inputs():
    rng = np.random.default_rng(1)
    v, b = 48, 16
    return dict(p0=rng.normal(scale=0.3, size=(v, 16)).astype(np.float32),
                p1=rng.normal(scale=0.3, size=(v, 16)).astype(np.float32),
                centers=rng.integers(0, v, b).astype(np.int32),
                contexts=rng.integers(0, v, (b, 4)).astype(np.int32),
                mask=rng.random((b, 4)) < 0.8,
                negs=rng.integers(0, v, (b, 4, 3)).astype(np.int32), v=v)


SGNS_CFG = SGNSConfig(dim=16, window=3, negative=4, epochs=2, batch_size=128)
REUSE_ORACLE_CFG = UniWalkConfig(sample=400, step=2, reuse_times=4, topk=5)


def reuse_oracle_walks():
    """The injected reuse walks: port walks on the CPU from one seed."""
    from graphtpu_torch.walks.walker import uniform_walks

    cfg = REUSE_ORACLE_CFG
    starts = torch.repeat_interleave(torch.arange(64, dtype=torch.int32),
                                     cfg.sample // cfg.reuse_times)
    return uniform_walks(build_graph(small_edges(), n_nodes=64), starts,
                         2 * cfg.step + cfg.reuse_times - 1, 13, device="cpu")


def sgns_walks():
    from graphtpu_torch.walks.walker import uniform_walks

    starts = torch.arange(64, dtype=torch.int32).repeat(3)
    return uniform_walks(build_graph(small_edges(), n_nodes=64), starts, 12, 9, device="cpu")


# ---------------------------------------------------------------------------
# what every rank runs


def _rank_cases(device, tmp):
    """Every case on this rank; rank 0 returns the gathered results."""
    import torch.distributed as dist

    from graphtpu_torch.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu_torch.dist.sgns_dp import make_sgns_train_step, train_sgns_dp
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.dist.spmm_sharded import gather_sim, sharded_simrank_spmm
    from graphtpu_torch.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu_torch.dist.uniwalk_dist import (
        distributed_uniwalk_simrank,
        distributed_uniwalk_simrank_reuse,
    )
    from graphtpu_torch.models import checkpoint as ckpt_mod

    out = {}
    mesh = tm.make_1d_mesh(device=device)
    grp = mesh.groups["data"]
    me = mesh.rank

    def gathered(x):
        return tm.gather_rows(x, grp).cpu().numpy()

    # meshes
    m2 = tm.make_mesh(model_parallel=2, device=device)
    g2 = tm.make_2d_mesh(2, 2, device=device)
    info = torch.tensor([m2.shape[0], m2.shape[1], *m2.coords,
                         dist.get_world_size(m2.groups["data"]),
                         dist.get_world_size(m2.groups["model"]), *g2.coords])
    out["mesh"] = tm.all_gather(info, grp).numpy()

    small = build_graph(small_edges(), n_nodes=64)
    medium = build_graph(medium_edges(), n_nodes=256)
    ew, ww = weighted_int_graph_inputs()
    wgraph = build_graph(ew, ww, n_nodes=64)

    # the shard blocks
    sg_med = shard_graph(medium, N_RANKS, mesh=mesh)
    out["shard_blocks"] = {k: gathered(getattr(sg_med, k)[None]) for k in ("row_ptr", "col", "deg")}

    # exchanges: every value to rank value % 4, int32 / int8 / int16 wire
    x = torch.arange(me * 8, me * 8 + 8, dtype=torch.int32)
    for wd in (None, torch.int8, torch.int16):
        tf.reset_wire_stats()
        (recv,), valid = tf.exchange_by_owner((x,), x % N_RANKS, grp, N_RANKS, 8,
                                              wire_dtypes=(wd,))
        out[f"exchange_{wd}"] = (gathered(recv[None]), recv.dtype, tf.wire_stats())

    # walks
    out["walks_small"] = gathered(tf.distributed_uniform_walks(small, 64, 6, 0, mesh))
    for name, g_ in (("rep", medium), ("shd", sg_med)):
        out[f"walks_med_{name}"] = gathered(tf.distributed_uniform_walks(g_, 128, 6, 5, mesh))
    sg_w = shard_graph(wgraph, N_RANKS, mesh=mesh)
    out["walks_w_rep"] = gathered(tf.distributed_uniform_walks(wgraph, 64, 6, 11, mesh,
                                                               weighted=True))
    out["walks_w_shd"] = gathered(tf.distributed_uniform_walks(sg_w, 64, 6, 11, mesh,
                                                               weighted=True))
    for steps in (1, 4):
        tf.reset_wire_stats()
        w = tf.distributed_uniform_walks(medium, 128, steps, 1, mesh)
        out[f"wire_walks_{steps}"] = (tf.wire_stats(), gathered(w))

    # exact SimRank: the 1-D ring (f32, weighted, bf16) and the dense form
    cfg3, cfg4 = SimRankConfig(iterations=3), SimRankConfig(iterations=4)
    ring_times, dense_times, sgns_times = {}, {}, {}
    out["ring_f32"] = gather_sim(sharded_simrank_spmm(small, mesh, cfg4,
                                                      stage_times=ring_times)).numpy()
    out["ring_stages"] = set(ring_times)
    out["ring_weighted"] = gather_sim(sharded_simrank_spmm(wgraph, mesh, cfg3,
                                                           weighted=True)).numpy()
    b16 = sharded_simrank_spmm(build_graph(bf16_edges(), n_nodes=256), mesh, cfg3,
                               dtype=torch.bfloat16)
    out["ring_bf16"] = (b16.values.dtype, gather_sim(b16).float().numpy())
    out["dense"] = gather_sim(sharded_exact_simrank(small, mesh, cfg3,
                                                    stage_times=dense_times)).numpy()
    out["dense_stages"] = set(dense_times)

    # UniWalk, the reuse form, TopSim
    out["uniwalk"] = distributed_uniwalk_simrank(small, mesh, UniWalkConfig(sample=6000, step=3,
                                                                            topk=5), key=3)
    out["uniwalk_windows"] = distributed_uniwalk_simrank(
        small, mesh, UniWalkConfig(sample=200, step=2, topk=5), key=1,
        max_walk_ints=16 * 200 * 5)
    out["reuse"] = distributed_uniwalk_simrank_reuse(
        small, mesh, UniWalkConfig(sample=6400, step=3, topk=5, reuse_times=4), key=7)
    rcfg = UniWalkConfig(sample=64, step=2, reuse_times=4, topk=5)
    out["reuse_rep"] = distributed_uniwalk_simrank_reuse(medium, mesh, rcfg, key=2)
    out["reuse_shd"] = distributed_uniwalk_simrank_reuse(sg_med, mesh, rcfg, key=2)
    out["reuse_oracle"] = distributed_uniwalk_simrank_reuse(small, mesh, REUSE_ORACLE_CFG,
                                                            walks=reuse_oracle_walks())
    tcfg = TopSimConfig(sample=2000.0, step=2, topk=5, source_tile=4)
    out["topsim_rep"] = distributed_topsim_simrank(small, mesh, tcfg, key=1)
    out["topsim_shd"] = distributed_topsim_simrank(shard_graph(small, N_RANKS, mesh=mesh), mesh,
                                                   tcfg, key=1)
    sparse = build_graph(sparse_edges(), n_nodes=64)
    out["topsim_det"] = distributed_topsim_simrank(
        shard_graph(sparse, N_RANKS, mesh=mesh), mesh,
        TopSimConfig(sample=1e6, step=2, topk=64, source_tile=8, frontier_capacity=16384),
        key=1, device_capacity=65536)

    # node2vec: validity over 10 hops; the joint (hop1, hop2) law from one start
    out["n2v_valid"] = gathered(distributed_node2vec_walks(
        shard_graph(small, N_RANKS, mesh=mesh), 128, 10, 0.25, 4.0, 2, mesh,
        starts=np.tile(np.arange(64, dtype=np.int32), 2)))
    n2v = build_graph(n2v_edges(), n_nodes=48)
    s0 = int(np.argmax(n2v.host[3]))
    starts = np.full(N2V_WALKERS, s0, np.int32)
    out["n2v_joint"] = gathered(distributed_node2vec_walks(
        shard_graph(n2v, N_RANKS, mesh=mesh), N2V_WALKERS, 2, 0.25, 2.0, 5, mesh, starts=starts))
    n2v_w = build_graph(n2v_edges(), np.random.default_rng(6).uniform(0.5, 2.0, len(n2v_edges()))
                        .astype(np.float32), n_nodes=48)
    out["n2v_joint_w"] = gathered(distributed_node2vec_walks(
        shard_graph(n2v_w, N_RANKS, mesh=mesh), N2V_WALKERS, 2, 2.0, 0.5, 6, mesh, starts=starts,
        weighted=True))

    # SGNS on the data axis: one step, the whole run with a resumed copy
    si = sgns_step_inputs()
    shard_params, shard_batch, train_step = make_sgns_train_step(mesh, SGNSConfig(dim=16, window=2,
                                                                                  negative=3),
                                                                 si["v"])
    params = shard_params((si["p0"], si["p1"]))
    batch = shard_batch(si["centers"], si["contexts"], si["mask"], si["negs"])
    out["sgns_step"] = tuple(p.numpy() for p in train_step(params, *batch, 0.05,
                                                           stage_times=sgns_times))
    out["sgns_stages"] = set(sgns_times)
    walks = sgns_walks()
    out["sgns_dp"] = train_sgns_dp(walks, 64, mesh, SGNS_CFG)
    ck, snap = os.path.join(tmp, "sgns_dp.ckpt"), os.path.join(tmp, "snap.ckpt")
    saves = {"n": 0}
    orig_save = ckpt_mod.save_state

    def snapping_save(path, arrays, step=0, meta=None):
        orig_save(path, arrays, step=step, meta=meta)
        saves["n"] += 1
        if saves["n"] == 1:  # the first mid-run checkpoint
            shutil.copy(path, snap)

    ckpt_mod.save_state = snapping_save
    try:
        train_sgns_dp(walks, 64, mesh, SGNS_CFG, checkpoint_path=ck, checkpoint_every=1)
    finally:
        ckpt_mod.save_state = orig_save
    dist.barrier()
    if me == 0:
        shutil.copy(snap, ck)  # rewind to mid-run (a simulated crash)
    dist.barrier()
    out["sgns_resumed"] = train_sgns_dp(walks, 64, mesh, SGNS_CFG, checkpoint_path=ck,
                                        checkpoint_every=1)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tm.spawn(_rank_cases, N_RANKS, "gloo", "cpu",
                    args=(str(tmp_path_factory.mktemp("ranks")),), timeout=900)


@pytest.fixture(scope="module")
def gt():
    """graphtpu and its dist modules (imported here, not at the top; see the
    module docstring)."""
    import jax
    import jax.numpy as jnp

    import graphtpu
    from graphtpu.core import config as jc
    from graphtpu.dist import frontier, mesh, sharded_graph, sgns_dp, spmm_sharded

    return SimpleNamespace(jax=jax, jnp=jnp, graphtpu=graphtpu, config=jc, frontier=frontier,
                           mesh=mesh, sharded_graph=sharded_graph, sgns_dp=sgns_dp,
                           spmm_sharded=spmm_sharded)


def exact(edges, v, iterations=3, weights=None, weighted=False):
    g = build_graph(edges, weights, n_nodes=v)
    return exact_simrank(g, SimRankConfig(iterations=iterations), weighted=weighted,
                         device="cpu").numpy()


def bf16_ulp(x):
    """One bf16 ulp at each entry's magnitude (0 for zeros)."""
    m, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(x != 0, np.ldexp(1.0, e - 8), 0.0)


def assert_bf16_close(got, want):
    np.testing.assert_array_less(np.abs(got - want), BF16_ULPS * bf16_ulp(want) + 1e-9)


def rank_overlap(vals, idx, gold):
    """graphtpu's ranking score: the share of each row's positive top-k that
    lies in the exact top-k of the same size."""
    hits = total = 0
    for r in range(gold.shape[0]):
        ia = set(idx[r][vals[r] > 0].tolist())
        if not ia:
            continue
        hits += len(ia & set(np.argsort(-gold[r])[: len(ia)].tolist()))
        total += len(ia)
    return hits / max(total, 1), total


def assert_edges(edges, v, walks, every=1):
    g = build_graph(edges, n_nodes=v)
    rp, col = g.host[0], g.host[1]
    for b in range(0, walks.shape[0], every):
        for t in range(walks.shape[1] - 1):
            u, x = walks[b, t], walks[b, t + 1]
            if x >= 0:
                assert x in col[rp[u]: rp[u + 1]], (b, t, u, x)


# ---------------------------------------------------------------------------
# meshes, shards, plans, exchanges


def test_meshes(ranks):
    info = ranks["mesh"]  # per rank: (data, model) shape, coords, group sizes, 2-D coords
    assert (info[:, :2] == [2, 2]).all()
    np.testing.assert_array_equal(info[:, 2:4], [[0, 0], [0, 1], [1, 0], [1, 1]])
    assert (info[:, 4:6] == 2).all()
    np.testing.assert_array_equal(info[:, 6:8], [[0, 0], [0, 1], [1, 0], [1, 1]])


@pytest.mark.parametrize("weighted", [False, True])
def test_shard_arrays_equal_graphtpu(gt, weighted):
    if weighted:
        edges, w = weighted_int_graph_inputs()
        v = 64
    else:
        edges, w, v = medium_edges(), None, 256
    jg = gt.graphtpu.build_graph(edges, w, n_nodes=v)
    want = gt.sharded_graph.shard_graph(jg, N_RANKS)
    got = shard_arrays(build_graph(edges, w, n_nodes=v), N_RANKS)
    for k in ("row_ptr", "col", "deg", "deg_global") + (("weight",) if weighted else ()):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        assert got[k].dtype == np.asarray(getattr(want, k)).dtype, k
    assert got["col"].shape[1] < jg.n_edges or weighted


def test_rank_blocks_are_their_rows(ranks):
    want = shard_arrays(build_graph(medium_edges(), n_nodes=256), N_RANKS)
    for k, got in ranks["shard_blocks"].items():
        np.testing.assert_array_equal(got, want[k], err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_tree_plan_equals_graphtpu(gt, weighted):
    if weighted:
        edges, w = weighted_int_graph_inputs()
        v = 64
    else:
        edges, w, v = medium_edges(), None, 256
    jg = gt.graphtpu.build_graph(edges, w, n_nodes=v)
    want = gt.spmm_sharded.build_sharded_tree_plan(jg, N_RANKS, weighted=weighted)
    got = build_sharded_tree_plan(build_graph(edges, w, n_nodes=v), N_RANKS, weighted=weighted)
    assert (got.rows_per, got.n_nodes, len(got.levels)) == (want.rows_per, want.n_nodes,
                                                            len(want.levels))
    for a, b in zip(got.levels + got.weights, want.levels + want.weights):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    # a rank holds ~E/n level-0 slots, far below E
    assert got.levels[0].shape[1] * got.levels[0].shape[2] < jg.n_edges or weighted


def test_pack_buckets_equal_graphtpu(gt):
    jnp = gt.jnp
    for pay, owner in (([10, 11, 12, 13, 14], [1, 0, 1, -1, 0]), (list(range(5)), [0] * 5)):
        want = np.asarray(gt.frontier._pack_buckets(jnp.array(pay, jnp.int32),
                                                    jnp.array(owner, jnp.int32), 2, 3, -1))
        got = tf._pack_buckets(torch.tensor(pay, dtype=torch.int32),
                               torch.tensor(owner, dtype=torch.int32), 2, 3, -1)
        np.testing.assert_array_equal(got.numpy(), want)
    # the overflow drop: five rows for owner 0, three fit
    assert (got[0] >= 0).sum() == 3 and (got[1] >= 0).sum() == 0


def test_narrowest_int_dtype():
    assert tf.narrowest_int_dtype(31) == torch.int8
    assert tf.narrowest_int_dtype(127) == torch.int8
    assert tf.narrowest_int_dtype(128) == torch.int16
    assert tf.narrowest_int_dtype(300) == torch.int16
    assert tf.narrowest_int_dtype(70000) == torch.int32


@pytest.mark.parametrize("wire", [None, "int8", "int16"])
def test_exchange_equals_graphtpu(gt, ranks, wire):
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jnp = gt.jnp
    mesh = gt.mesh.make_1d_mesh(N_RANKS)
    wd = None if wire is None else getattr(jnp, wire)
    gt.frontier.reset_wire_stats()

    @partial(shard_map, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))
    def run(x):
        (recv,), _ = gt.frontier.exchange_by_owner((x,), x % N_RANKS, "data", N_RANKS, 8,
                                                   wire_dtypes=(wd,))
        return recv[None, :]

    want = np.asarray(run(jnp.arange(32, dtype=jnp.int32)))
    want_stats = gt.frontier.wire_stats()
    got, dtype, stats = ranks[f"exchange_{None if wire is None else getattr(torch, wire)}"]
    np.testing.assert_array_equal(got, want)  # routing, bucket order, padding
    assert dtype == torch.int32  # widened back after the wire
    for d in range(N_RANKS):
        assert sorted(got[d][got[d] >= 0].tolist()) == [x for x in range(32) if x % 4 == d]
    # one exchange run once: the port's per-rank count equals graphtpu's trace count
    assert stats == want_stats


def test_packed_exchange_equals_unpacked(ranks):
    base = ranks["exchange_None"][0]
    for wd in (torch.int8, torch.int16):
        np.testing.assert_array_equal(ranks[f"exchange_{wd}"][0], base)


# ---------------------------------------------------------------------------
# walks


def test_walks_are_edges(ranks):
    w = ranks["walks_small"]
    assert w.shape == (64, 7) and (w[:, 0] >= 0).all()
    assert_edges(small_edges(), 64, w)


def test_sharded_walks_equal_replicated(ranks):
    np.testing.assert_array_equal(ranks["walks_med_shd"], ranks["walks_med_rep"])
    assert_edges(medium_edges(), 256, ranks["walks_med_shd"], every=7)
    assert (ranks["walks_med_rep"][:, 1:] >= 0).mean() > 0.99


def test_weighted_sharded_walks_equal_replicated(ranks):
    np.testing.assert_array_equal(ranks["walks_w_shd"], ranks["walks_w_rep"])
    assert_edges(weighted_int_graph_inputs()[0], 64, ranks["walks_w_shd"])


def test_walk_wire_bytes(gt, ranks):
    """Short-packed buckets: at least 2x fewer bytes than int32; a hop's bytes
    equal graphtpu's (which counts the traced loop body once) and the port
    counts each hop it runs."""
    jg = gt.graphtpu.build_graph(medium_edges(), n_nodes=256)
    gt.frontier.reset_wire_stats()
    gt.frontier.distributed_uniform_walks(jg, n_walkers=128, num_steps=4,
                                          key=gt.jax.random.key(1),
                                          mesh=gt.mesh.make_1d_mesh(N_RANKS))
    want = gt.frontier.wire_stats()
    one, _ = ranks["wire_walks_1"]
    four, w = ranks["wire_walks_4"]
    assert one == want
    assert four == {k: 4 * x for k, x in want.items()}
    assert four["bytes"] * 2 <= four["bytes_unpacked"]
    assert (w[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# sharded exact SimRank: the ring and the dense form


def test_ring_equals_graphtpu(gt, ranks):
    jg = gt.graphtpu.build_graph(small_edges(), n_nodes=64)
    want = np.asarray(gt.spmm_sharded.sharded_simrank_spmm(
        jg, gt.mesh.make_1d_mesh(N_RANKS), gt.config.SimRankConfig(iterations=4)))
    got = ranks["ring_f32"]
    np.testing.assert_allclose(got, want, atol=TOL_F32)
    np.testing.assert_allclose(got, exact(small_edges(), 64, iterations=4), atol=TOL_DENSE)
    assert ranks["ring_stages"] == {"plan", "b3", "wire", "local"}


def test_weighted_ring_equals_graphtpu(gt, ranks):
    edges, w = weighted_int_graph_inputs()
    jg = gt.graphtpu.build_graph(edges, w, n_nodes=64)
    want = np.asarray(gt.spmm_sharded.sharded_simrank_spmm(
        jg, gt.mesh.make_1d_mesh(N_RANKS), gt.config.SimRankConfig(iterations=3),
        weighted=True))
    got = ranks["ring_weighted"]
    np.testing.assert_allclose(got, want, atol=TOL_F32)
    np.testing.assert_allclose(got, exact(edges, 64, weights=w, weighted=True), atol=TOL_DENSE)


def test_bf16_ring_equals_graphtpu(gt, ranks):
    jnp = gt.jnp
    jg = gt.graphtpu.build_graph(bf16_edges(), n_nodes=256)
    want = np.asarray(gt.spmm_sharded.sharded_simrank_spmm(
        jg, gt.mesh.make_1d_mesh(N_RANKS), gt.config.SimRankConfig(iterations=3),
        dtype=jnp.bfloat16).astype(jnp.float32))
    dtype, got = ranks["ring_bf16"]
    assert dtype == torch.bfloat16
    assert_bf16_close(got, want)
    # graphtpu's own bar against f32: max error 2e-2 and top-10 agreement
    f32 = exact(bf16_edges(), 256)
    assert np.abs(got - f32).max() < 2e-2
    agree = [len(set(np.argsort(-f32[r])[:10]) & set(np.argsort(-got[r])[:10])) / 10
             for r in range(0, 256, 11)]
    assert np.mean(agree) >= 0.9


def test_sharded_dense_simrank(ranks):
    np.testing.assert_allclose(ranks["dense"], exact(small_edges(), 64), atol=TOL_DENSE)
    assert ranks["dense_stages"] == {"plan", "matmul", "wire"}


# ---------------------------------------------------------------------------
# the Monte-Carlo engines


def test_uniwalk_ranking(ranks):
    vals, idx = ranks["uniwalk"]
    assert vals.shape == (64, 5)
    score, total = rank_overlap(vals, idx, exact(small_edges(), 64))
    assert total > 0 and score > 0.7, score


def test_uniwalk_internal_windows(ranks):
    vals, idx = ranks["uniwalk_windows"]
    assert vals.shape == (64, 5)
    assert (vals >= 0).all() and np.isfinite(vals).all()
    assert ((idx >= -1) & (idx < 64)).all()


def test_reuse_ranking(ranks):
    vals, idx = ranks["reuse"]
    assert vals.shape == (64, 5) and (vals >= 0).all()
    for r in range(64):
        assert r not in set(idx[r][vals[r] > 0].tolist())  # diag zeroed on the owner
    score, total = rank_overlap(vals, idx, exact(small_edges(), 64))
    assert total > 0 and score > 0.7, score


def test_reuse_sharded_equals_replicated(ranks):
    v1, i1 = ranks["reuse_rep"]
    v2, i2 = ranks["reuse_shd"]
    np.testing.assert_allclose(v1, v2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)


def test_reuse_equals_dense_oracle(ranks):
    """The same walks through the item-routed flush and the single-device
    dense reuse oracle: only the order of the sums differs."""
    from graphtpu_torch.simrank.uniwalk import uniwalk_simrank_reuse

    cfg = REUSE_ORACLE_CFG
    dense = uniwalk_simrank_reuse(build_graph(small_edges(), n_nodes=64), cfg,
                                  walks=reuse_oracle_walks(), device="cpu")
    vals, idx = ranks["reuse_oracle"]
    for r in range(64):
        np.testing.assert_allclose(vals[r], np.sort(dense[r])[-cfg.topk:][::-1], atol=1e-6)
        ok = idx[r] >= 0
        np.testing.assert_allclose(vals[r][ok], dense[r][idx[r][ok]], atol=1e-6)


def _topsim_overlap(dv, di, lv, li):
    hits = sum(len(set(di[r][dv[r] > 0]) & set(li[r][lv[r] > 0])) for r in range(64))
    return hits / max(sum(len(set(li[r][lv[r] > 0])) for r in range(64)), 1)


@pytest.mark.parametrize("form", ["rep", "shd"])
def test_topsim_statistical(ranks, form):
    from graphtpu_torch.simrank.topsim import topsim_simrank

    cfg = TopSimConfig(sample=2000.0, step=2, topk=5, source_tile=4)
    dv, di = ranks[f"topsim_{form}"]
    assert dv.shape == (64, 5)
    lv, li = topsim_simrank(build_graph(small_edges(), n_nodes=64), cfg, key=2, device="cpu")
    assert _topsim_overlap(dv, di, lv, li) > 0.72


def test_sharded_topsim_deterministic(ranks):
    """mass >= degree everywhere: every expansion is an even split, so the
    owner exchange must reproduce the single-device mass exactly."""
    from graphtpu_torch.simrank.topsim import topsim_simrank

    cfg = TopSimConfig(sample=1e6, step=2, topk=64, source_tile=8, frontier_capacity=16384)
    dense = topsim_simrank(build_graph(sparse_edges(), n_nodes=64), cfg, key=2, dense=True,
                           device="cpu")
    dv, di = ranks["topsim_det"]
    got = np.zeros_like(dense)
    for r in range(64):
        ok = di[r] >= 0
        got[r, di[r][ok]] = dv[r][ok]
    np.testing.assert_allclose(got, dense, rtol=2e-3, atol=2e-6)


# ---------------------------------------------------------------------------
# node2vec


def test_node2vec_walks_are_edges(ranks):
    w = ranks["n2v_valid"]
    assert w.shape == (128, 11) and (w >= 0).all()
    assert_edges(small_edges(), 64, w)


@pytest.mark.parametrize("weighted", [False, True])
def test_node2vec_joint_law(ranks, weighted):
    edges = n2v_edges()
    wts = (np.random.default_rng(6).uniform(0.5, 2.0, len(edges)).astype(np.float32)
           if weighted else None)
    g = build_graph(edges, wts, n_nodes=48)
    p, q = (2.0, 0.5) if weighted else (0.25, 2.0)
    w = ranks["n2v_joint_w" if weighted else "n2v_joint"]
    assert (w >= 0).all()
    rp, col, wt, deg = g.host
    s0 = int(np.argmax(deg))
    emp = np.zeros((48, 48))
    np.add.at(emp, (w[:, 1], w[:, 2]), 1.0)
    emp /= len(w)
    nb = col[rp[s0]: rp[s0 + 1]]
    first = np.ones(len(nb)) if wt is None else wt[rp[s0]: rp[s0 + 1]].astype(np.float64)
    first /= first.sum()
    want = np.zeros((48, 48))
    for c1, pc in zip(nb, first):
        want[c1] += pc * node2vec_transition_probs(g, s0, int(c1), p, q)
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv < N2V_TV, tv


# ---------------------------------------------------------------------------
# SGNS


def test_sgns_step_equals_graphtpu(gt, ranks):
    from jax.numpy import asarray as ja

    si = sgns_step_inputs()
    mesh = gt.mesh.make_mesh(8, model_parallel=2)
    shard_params, shard_batch, train_step = gt.sgns_dp.make_sgns_train_step(
        mesh, gt.config.SGNSConfig(dim=16, window=2, negative=3), si["v"])
    want = train_step(shard_params((ja(si["p0"]), ja(si["p1"]))),
                      *shard_batch(ja(si["centers"]), ja(si["contexts"]), ja(si["mask"]),
                                   ja(si["negs"])), 0.05)
    for a, b in zip(ranks["sgns_step"], want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    assert ranks["sgns_stages"] == {"lookup", "compute", "update", "lookup_bytes",
                                    "update_bytes"}


def test_train_sgns_dp_equals_single_device(ranks):
    from graphtpu_torch.models.sgns import train_sgns

    s0, s1 = train_sgns(sgns_walks(), 64, SGNS_CFG, device="cpu")
    d0, d1 = ranks["sgns_dp"]
    np.testing.assert_allclose(d0, s0, atol=1e-5)
    np.testing.assert_allclose(d1, s1, atol=1e-5)
    np.testing.assert_allclose(ranks["sgns_resumed"][0], d0, atol=1e-6)


# ---------------------------------------------------------------------------
# the dry run


def test_dryrun_four_ranks():
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch.dryrun", "4", "--device", "cpu"],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout.splitlines()[-1]


# ---------------------------------------------------------------------------
# the launcher and the flagship run


def _fails_on_rank_one(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return "unreachable"


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank one fails"):
        tm.spawn(_fails_on_rank_one, 2, "gloo", "cpu", timeout=120)


def test_flagship_stops_by_budget_and_resumes(tmp_path):
    """tools/run_10m_flagship.py's flow at a cut size on the CPU: two windows,
    stopped, then a resumed run for the third; every source once."""
    from graphtpu_torch.bench.flagship import run_flagship
    from graphtpu_torch.dist.windows import read_sweep_results

    kw = dict(v=3000, avg_deg=8, sample=100, times=4, stop_v=300, window=100, tile=64,
              graph_path=str(tmp_path / "g.txt"), out_dir=str(tmp_path / "out"), device="cpu",
              log=lambda msg: None)
    first = run_flagship(**kw, window_budget=2)
    assert first["generate_s"] is not None and not first["complete"]
    assert first["windows_done"] == 2 and len(first["tile_s"]) == 4
    second = run_flagship(**kw)
    assert second["generate_s"] is None and second["complete"] and second["windows_done"] == 1
    merged = read_sweep_results(kw["out_dir"])
    assert sorted(merged) == list(range(300))
    assert all(0 <= i < 3000 and i != s and x >= 0 for s, p in merged.items() for i, x in p)
    assert sum(bool(p) for p in merged.values()) > 290  # isolated sources have no row
    timed_out = run_flagship(**dict(kw, out_dir=str(tmp_path / "out2")), budget_s=0.0)
    assert timed_out["tile_s"] == [] and not timed_out["complete"]
