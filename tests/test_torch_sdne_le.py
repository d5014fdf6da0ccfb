"""graphtpu_torch's SDNE and Laplacian Eigenmaps against graphtpu's: SDNE's
activations and loss terms, 60 trained steps from graphtpu's initial
parameters, the swiss roll's points, the kNN heat affinity, and LE's kept
eigenvalues and column subspaces on inputs with a clear spectral gap."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphtpu.core.config import LEConfig as JLEConfig
from graphtpu.core.config import SDNEConfig as JSDNEConfig
from graphtpu.models import lapeigen as jle
from graphtpu.models import sdne as jsd
from graphtpu_torch.core.config import LEConfig, SDNEConfig
from graphtpu_torch.core.convert import sdne_params_from_numpy
from graphtpu_torch.models import lapeigen as tle
from graphtpu_torch.models import sdne as tsd

torch.set_num_threads(1)
RTOL = 1e-5        # one float32 forward pass and its loss terms
TRAINED_RTOL = 1e-4  # 60 Adam steps at lr 0.01, relative to each tensor's largest entry
EVAL_TOL = 1e-5    # kept eigenvalues, float32 eigh on two LAPACK builds
MIN_COS = 0.999    # |cos| of kept eigenvector columns (or principal angles)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


def test_sdne_forward_and_loss_match():
    cfg = SDNEConfig(units=(20, 12, 6, 10, 20), minibatch=16)
    jp = jsd.init_params(JSDNEConfig(units=cfg.units, minibatch=16), jax.random.key(2))
    x = np.random.default_rng(0).random((16, 20)).astype(np.float32)
    tp = sdne_params_from_numpy(_np(jp), "cpu")
    ja, ta = jsd.forward(jp, jnp.asarray(x)), tsd.forward(tp, torch.from_numpy(x))
    for name in ("hidden1", "answer", "hidden2", "hidden3", "y"):
        _close(ta[name].numpy(), np.asarray(ja[name]), RTOL)
    jt, jterms = jsd.loss_fn(jp, jnp.asarray(x), JSDNEConfig(units=cfg.units, minibatch=16))
    tt, tterms = tsd.loss_fn(tp, torch.from_numpy(x), cfg)
    _close(tt.item(), float(jt), RTOL)
    for k in ("recon", "reg1", "reg2"):
        _close(tterms[k].item(), float(jterms[k]), RTOL)


def _digits():
    from sklearn.datasets import load_digits

    x = (load_digits().data / 16.0).astype(np.float32)[:500]
    jcfg = JSDNEConfig(units=(64, 40, 16, 30, 64), minibatch=100, seed=3)
    return x, jcfg, jsd.init_params(jcfg, jax.random.key(jcfg.seed))  # graphtpu's start


def _graphtpu_steps(init, x, jcfg, steps, dtype):
    """graphtpu's train_sdne loop (models/sdne.py:88-102) in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        params = [(jnp.asarray(w, dtype), jnp.asarray(b, dtype)) for w, b in _np(init)]
        opt = optax.adam(jcfg.learning_rate)
        state = opt.init(params)
        xa = jnp.asarray(x, dtype)

        @jax.jit
        def step(params, state, xb):
            grads = jax.grad(lambda p: jsd.loss_fn(p, xb, jcfg)[0])(params)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(params, updates), state

        for i in range(steps):
            start = (i % 5) * 100
            params, state = step(params, state, xa[start:start + 100])
        return _np(params)


def test_sdne_60_steps_on_digits_match_graphtpu():
    """The port's train_sdne against graphtpu's training run in float64
    (graphtpu's loss_fn and optax.adam), and against graphtpu's float32
    train_sdne once optax's float32 bias corrections are taken into the
    port's steps: optax computes 1 - 0.999^t in float32, off by up to 2e-5
    relative, and this run amplifies that to 2.4e-2 on w2 after 60 steps
    (ROADMAP C4); the port's float64 corrections keep it within 4e-7 of
    the float64 run."""
    x, jcfg, init = _digits()
    cfg = SDNEConfig(units=jcfg.units, minibatch=100, seed=3)
    tp, tembed = tsd.train_sdne(x, cfg, steps=60, params=sdne_params_from_numpy(_np(init), "cpu"),
                                device="cpu")
    gold = _graphtpu_steps(init, x, jcfg, 60, np.float64)
    for (tw, tb), (jw, jb) in zip(tp, gold):
        _close(tw.numpy(), jw, TRAINED_RTOL)
        _close(tb.numpy(), jb, TRAINED_RTOL)
    want = tsd.forward(sdne_params_from_numpy(gold, "cpu"), torch.from_numpy(x[:50]))["answer"]
    _close(tembed(x[:50]), want.numpy(), TRAINED_RTOL)

    # graphtpu's float32 train_sdne, against the port's loss and gradients
    # stepped by optax's float32 arithmetic
    jp, _ = jsd.train_sdne(x, jcfg, steps=60)
    leaves = [t.requires_grad_() for pair in sdne_params_from_numpy(_np(init), "cpu") for t in pair]
    params = list(zip(leaves[0::2], leaves[1::2]))
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    b1, b2 = np.float32(0.9), np.float32(0.999)
    for i in range(60):
        total, _ = tsd.loss_fn(params, torch.from_numpy(x[(i % 5) * 100:(i % 5) * 100 + 100]), cfg)
        for t in leaves:
            t.grad = None
        total.backward()
        with torch.no_grad():
            c1, c2 = 1 - b1 ** np.float32(i + 1), 1 - b2 ** np.float32(i + 1)
            for t, mm, vv in zip(leaves, m, v):
                mm.copy_((1 - 0.9) * t.grad + 0.9 * mm)
                vv.copy_((1 - 0.999) * t.grad * t.grad + 0.999 * vv)
                t.sub_(0.01 * ((mm / c1) / (torch.sqrt(vv / c2) + 1e-8)))
    for (tw, tb), (jw, jb) in zip(params, jp):
        _close(tw.detach().numpy(), np.asarray(jw), TRAINED_RTOL)
        _close(tb.detach().numpy(), np.asarray(jb), TRAINED_RTOL)
    assert np.abs(np.asarray(jp[1][0]) - gold[1][0]).max() > 1e-3 * np.abs(gold[1][0]).max()


def test_sdne_default_init_is_seeded():
    cfg = SDNEConfig(units=(8, 6, 3, 6, 8), minibatch=4)
    x = np.random.default_rng(1).random((12, 8)).astype(np.float32)
    a, ea = tsd.train_sdne(x, cfg, steps=5, device="cpu")
    b, eb = tsd.train_sdne(x, cfg, steps=5, device="cpu")
    for (wa, _), (wb, _) in zip(a, b):
        assert torch.equal(wa, wb)
    w = tsd.init_params(SDNEConfig(), 0, "cpu")[0][0]
    assert w.abs().max() <= 0.2 and abs(w.std().item() - 0.088) < 0.005  # 0.1 x N(0,1) cut at 2 sd
    np.testing.assert_array_equal(ea(x), eb(x))


def test_swiss_roll_seed0_equals_graphtpu():
    for n, noise in ((2000, 0.0), (300, 0.05)):
        np.testing.assert_array_equal(tle.make_swiss_roll(n, noise=noise),
                                      jle.make_swiss_roll(n, noise=noise))


def test_knn_heat_affinity_matches():
    x = np.random.default_rng(0).random((80, 3)).astype(np.float32)
    for k, t in ((5, 2.0), (10, 0.5)):
        got = tle.knn_heat_affinity(torch.from_numpy(x), k, t).numpy()
        want = np.asarray(jle.knn_heat_affinity(jnp.asarray(x), k, t))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert ((got > 0) == (want > 0)).all()


def _subspace_cos(a, b):
    """Cosines of the principal angles between the column spans of a and b."""
    qa, _ = np.linalg.qr(a.astype(np.float64))
    qb, _ = np.linalg.qr(b.astype(np.float64))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def test_le_circle_kept_eigenvalues_and_subspace():
    n = 60
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    ty, tv = tle.le_embed_points(x, LEConfig(k_neighbors=4, heat_t=1.0, out_dim=2), device="cpu")
    jy, jv = jle.le_embed_points(x, JLEConfig(k_neighbors=4, heat_t=1.0, out_dim=2))
    np.testing.assert_allclose(tv, jv, atol=EVAL_TOL)
    # the circle's first two modes share one eigenvalue: only their span is fixed
    assert _subspace_cos(ty, jy).min() >= MIN_COS


def _two_clusters(seed=0, sizes=(12, 20)):
    """A sim dict of two dense clusters joined by a few weak pairs."""
    rng = np.random.default_rng(seed)
    sims, base = {}, 0
    for size in sizes:
        for i in range(size):
            nb = rng.choice(size, 6, replace=False)
            sims[base + i] = [(base + int(j), float(0.2 + 0.6 * rng.random())) for j in nb if j != i]
        base += size
    for a, b in ((0, 12), (5, 20), (9, 30)):
        sims[a].append((b, 0.01))
    return sims, base


def test_le_two_clusters_kept_eigenvalues_and_columns():
    sims, n = _two_clusters()
    cfg = LEConfig(out_dim=2)
    ty, tv = tle.le_embed_sim_dict(sims, n, cfg, device="cpu")
    jy, jv = jle.le_embed_sim_dict(sims, n, JLEConfig(out_dim=2))
    np.testing.assert_allclose(tv, jv, atol=EVAL_TOL)
    assert tv[0] < 0.05 < tv[1]  # the Fiedler value, then a gap
    cos = np.abs((ty * jy).sum(0)) / (np.linalg.norm(ty, axis=0) * np.linalg.norm(jy, axis=0))
    assert cos.min() >= MIN_COS, cos
    # the Fiedler vector splits the clusters
    assert len({np.sign(v) for v in ty[:12, 0]}) == 1 and np.sign(ty[0, 0]) != np.sign(ty[-1, 0])


def test_le_stage_times_and_affinity():
    sims, n = _two_clusters(1)
    times = {}
    tle.le_embed_sim_dict(sims, n, device="cpu", stage_times=times)
    assert list(times) == ["eigh"] and times["eigh"] >= 0
    w = tle.sim_dict_affinity(sims, n)
    assert (w == w.T).all() and w[0, 12] == np.float32(0.01)


def test_le_plot_without_matplotlib_names_it(tmp_path, monkeypatch):
    import builtins

    from graphtpu_torch.cli import main as t_main

    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        t_main(["le", "--output", str(tmp_path / "y.npy"), "--plot", "--device", "cpu"])
