"""graphtpu_torch's DeepSim, SDNE, Laplacian Eigenmaps and support modules
on an NVIDIA GPU against their CPU runs: sim lookups and BFS exactly, a
DeepSim step within 1e-5, an SDNE step's loss and gradients within 1e-5
and its Adam update within 1e-5 plus the update's slope times the
gradients' difference, seeded DeepSim runs and the weight statistics
bit-equal run to run, LE eigenvalues within 1e-4.  And the dense SimRank
forms' ``matmul_precision`` on the card: "high" (full float32) bit-equal
to "highest", "default" (TF32) different from it but within its TF32
bound (derived beside ``tf32_bound_exact`` and ``tf32_bound_meeting``).  Every
test needs a card and skips without one.  This file imports neither jax nor
graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_models_cuda.py
"""

import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.core import stats
from graphtpu_torch.core.config import (
    DeepSimConfig,
    LEConfig,
    SDNEConfig,
    SimRankConfig,
    TopSimConfig,
)
from graphtpu_torch.core.device import full_fp32
from graphtpu_torch.core.traversal import bfs_distances
from graphtpu_torch.models import deepsim as ds
from graphtpu_torch.models import lapeigen as le
from graphtpu_torch.models import sdne

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
STEP_RTOL = 1e-5  # one float32 step on two devices, relative to each tensor's largest entry
EVAL_TOL = 1e-4   # float32 eigh on the card (cuSOLVER) and the CPU (LAPACK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _close(got, want, rtol=STEP_RTOL):
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _sims(v=500, k=20, seed=0):
    rng = np.random.default_rng(seed)
    return {s: [(int(d), float(x)) for d, x in zip(rng.choice(v, k, replace=False), rng.random(k))]
            for s in range(v) if s % 17}


def _graph(v=600, e=5000, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v - 40, (e, 2))
    return gt.build_graph(edges[edges[:, 0] != edges[:, 1]], n_nodes=v)


def test_lookup_sim_card_equals_cpu(cuda):
    v = 500
    table = ds.build_sim_table(_sims(v), v)
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, v, 4000).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, v, (4000, 21)).astype(np.int32))
    got = ds.lookup_sim(tuple(t.to(cuda) for t in table), src.to(cuda), dst.to(cuda))
    assert torch.equal(got.cpu(), ds.lookup_sim(table, src, dst))


def test_bfs_card_equals_cpu(cuda):
    g = _graph()
    src = np.arange(0, 600, 9, dtype=np.int32)
    np.testing.assert_array_equal(bfs_distances(g, src, device=cuda),
                                  bfs_distances(g, src, device="cpu"))


def _deepsim_setup(device, v=500):
    cfg = DeepSimConfig(dim=32, window=4, minibatch=64)
    table = tuple(t.to(device) for t in ds.build_sim_table(_sims(v), v))
    walks = torch.from_numpy(np.random.default_rng(2).integers(0, v, (300, 40)).astype(np.int32))
    params = ds.init_params(cfg, v, 7, "cpu")
    return cfg, table, walks.to(device), params


def test_deepsim_step_card_equals_cpu(cuda):
    wi = torch.from_numpy(np.random.default_rng(3).integers(0, 300, 64))
    pos = torch.from_numpy(np.random.default_rng(4).integers(4, 36, 64))
    models = []
    for dev in ("cpu", cuda):
        cfg, table, walks, params = _deepsim_setup(dev)
        trainer = ds.Trainer(walks, table, params, cfg, 0, dev)
        with full_fp32():
            loss = trainer.step(wi.to(dev), pos.to(dev))
        models.append((loss, trainer.model))
    (lc, mc), (lg, mg) = models
    _close(lg, lc)
    for a, b in zip(mg.params(), mc.params()):
        _close(a, b)


def test_seeded_deepsim_runs_are_bit_equal(cuda):
    cfg, table, walks, _ = _deepsim_setup(cuda)
    a = ds.train_deepsim(walks, table, 500, cfg, key=9, steps=50, device=cuda)
    b = ds.train_deepsim(walks, table, 500, cfg, key=9, steps=50, device=cuda)
    np.testing.assert_array_equal(a, b)


def test_sdne_step_card_equals_cpu(cuda):
    cfg = SDNEConfig(units=(300, 120, 40, 90, 300), minibatch=50)
    x = np.random.default_rng(5).random((50, 300), dtype=np.float32)
    init = sdne.init_params(cfg, 1, "cpu")
    runs = []
    for dev in ("cpu", cuda):
        trainer = sdne.Trainer(x, init, cfg, dev)
        with full_fp32():
            loss, _ = trainer.step()
        runs.append((loss, [t.grad for t in trainer.leaves], trainer.leaves))
    (lc, gc, pc), (lg, gg, pg) = runs
    _close(lg, lc)
    for a, b in zip(gg, gc):
        _close(a, b)
    # Adam's first step moves each weight by lr * g / (|g| + eps), whose
    # slope is at most 1 / (|g| + eps): a gradient near eps amplifies its
    # rounding, so each weight may differ by that slope times the gradients'
    # difference between the devices
    for a, b, ga, gb in zip(pg, pc, gg, gc):
        a, b = a.detach().cpu().double(), b.detach().double()
        ga, gb = ga.cpu().double(), gb.double()
        same = torch.sign(ga) == torch.sign(gb)
        slope = 1.0 / (torch.where(same, torch.minimum(ga.abs(), gb.abs()), 0.0) + 1e-8)
        allowed = STEP_RTOL * b.abs().max() + cfg.learning_rate * slope * (ga - gb).abs()
        assert ((a - b).abs() <= allowed).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_weight_stats_bit_equal_run_to_run(cuda, weighted):
    rng = np.random.default_rng(6)
    edges = rng.integers(0, 2000, (40_000, 2))
    wts = rng.uniform(0.1, 1.1, len(edges)).astype(np.float32) if weighted else None
    g = gt.build_graph(edges, wts, n_nodes=2048, device=cuda)
    for fn in (stats.out_weight_sums, stats.out_weight_variance):
        assert torch.equal(fn(g), fn(g))
        _close(fn(g), fn(g.to("cpu")))


def test_le_eigenvalues_card_equal_cpu(cuda):
    x = le.make_swiss_roll(600)
    cfg = LEConfig(out_dim=4)
    yg, eg = le.le_embed_points(x, cfg, device=cuda)
    yc, ec = le.le_embed_points(x, cfg, device="cpu")
    np.testing.assert_allclose(eg, ec, atol=EVAL_TOL)
    assert yg.shape == yc.shape == (600, 4) and np.isfinite(yg).all()


# TF32 keeps 10 of float32's 23 stored bits: an operand rounded to nearest
# is off by at most DELTA of itself.
DELTA = 2.0 ** -11


def tf32_bound_exact(iterations):
    """S' = c·W·(S·Wᵀ), W row-stochastic, 0 <= S <= 1: a product of two
    rounded operands (row weights summing to 1, entries at most 1) adds at
    most 2·DELTA to the error it inherits, an iteration has two and is
    scaled by c < 1, so the error stays below 4·DELTA·c/(1 - c) = 6·DELTA at
    c = 0.6; held at the looser 2·k·DELTA (chip_smoke.py's
    TOL_TF32_SIMRANK), which leaves room for float32's own rounding."""
    return 2 * iterations * DELTA


def tf32_bound_meeting(cfg):
    """sum_t c^t M_t M_tᵀ with M_t = M_{t-1} P: each product by the
    row-stochastic P adds at most 2·DELTA to M's row error (max row sum), so
    M_t's is at most 2·t·DELTA; an entry of M_t M_tᵀ is then off by at most
    twice that plus its own rounding, 2·DELTA: in all 2·DELTA·sum_t c^t
    (2t + 1), doubled for float32's own rounding."""
    return 2 * 2 * DELTA * sum(cfg.c ** t * (2 * t + 1) for t in range(1, cfg.step + 1))


@pytest.mark.parametrize("form", ["exact", "meeting"])
def test_dense_precision_modes(cuda, form):
    from graphtpu_torch.simrank.exact import exact_simrank
    from graphtpu_torch.simrank.meeting import doublesample_similarity

    g = _graph(v=2048, e=16_000, seed=4)
    if form == "exact":
        cfg = SimRankConfig(iterations=5)
        run = lambda p: exact_simrank(g, cfg, matmul_precision=p, device=cuda).cpu().numpy()
        bound = tf32_bound_exact(cfg.iterations)
    else:
        cfg = TopSimConfig(step=3)
        run = lambda p: doublesample_similarity(g, cfg, matmul_precision=p, device=cuda)
        bound = tf32_bound_meeting(cfg)
    highest = run("highest")
    np.testing.assert_array_equal(run("high"), highest)
    np.testing.assert_array_equal(run("float32"), highest)
    tf32 = run("default")
    err = np.abs(tf32 - highest).max()
    assert 0 < err <= bound, (err, bound)
    np.testing.assert_array_equal(run("bfloat16"), tf32)
