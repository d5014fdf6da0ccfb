"""graphtpu_torch's DeepSim path against graphtpu's: the sim table and its
lookups exactly, the loss and its gradients, Adam steps from the same
parameters on the same drawn (walk, position) pairs against optax, the
checkpoint indices, the walks.txt cache's bytes and the two diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphtpu import build_graph as j_build_graph
from graphtpu.core.config import DeepSimConfig as JDeepSimConfig
from graphtpu.models import deepsim as jds
from graphtpu import pipelines_deepsim as jpd
from graphtpu_torch import build_graph
from graphtpu_torch.core.config import DeepSimConfig
from graphtpu_torch.core.convert import deepsim_params_from_numpy
from graphtpu_torch.models import deepsim as tds
from graphtpu_torch import pipelines_deepsim as tpd

torch.set_num_threads(1)
RTOL = 1e-5  # float32 loss, gradients and Adam steps, relative to each tensor's largest entry


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def _random_sims(seed, v=40, k=8, empty=(3, 17)):
    """{src: [(nbr, sim), ...]}, unsorted, with tiny sims to drop and empty rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(v):
        if s in empty:
            out[s] = []
            continue
        nbrs = rng.choice(v, size=rng.integers(1, k + 1), replace=False)
        vals = rng.random(len(nbrs)).astype(np.float32)
        vals[rng.random(len(nbrs)) < 0.15] = 1e-9
        out[s] = [(int(a), float(b)) for a, b in zip(nbrs, vals)]
    return out


def _tables(sims, v, k_max=0):
    jt = jds.build_sim_table(sims, v, k_max)
    tt = tds.build_sim_table(sims, v, k_max)
    return jt, tt


def test_sim_table_lookup_reference_case():
    sims = {0: [(3, 0.5), (1, 0.2)], 2: [(0, 0.9)]}
    jt, tt = _tables(sims, 4)
    src = np.array([0, 0, 2, 1], np.int32)
    dst = np.array([[3], [2], [0], [3]], np.int32)
    got = tds.lookup_sim(tt, torch.from_numpy(src), torch.from_numpy(dst))
    want = np.asarray(jds.lookup_sim(jt, jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], np.float32([0.5, 0.2, 0.9, 0.0]))


@pytest.mark.parametrize("seed,k_max", [(0, 0), (1, 5), (2, 0)])
def test_sim_table_and_lookup_match_exactly(seed, k_max):
    v = 40
    sims = _random_sims(seed, v)
    jt, tt = _tables(sims, v, k_max)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(seed + 10)
    src = rng.integers(0, v, 300).astype(np.int32)
    dst = rng.integers(0, v, (300, 21)).astype(np.int32)
    got = tds.lookup_sim(tt, torch.from_numpy(src), torch.from_numpy(dst))
    want = np.asarray(jds.lookup_sim(jt, jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_array_equal(got.numpy(), want)
    hits = got.numpy() != np.asarray(jt[2])[src][:, None]
    assert hits.any() and (~hits).any()  # both hits and misses were looked up


def _problem(v=30, d=6, b=8, w=2, seed=0):
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(v, d)).astype(np.float32), (0.1 * rng.normal(size=d)).astype(np.float32),
              rng.normal(size=(d, v)).astype(np.float32), (0.1 * rng.normal(size=v)).astype(np.float32))
    centers = rng.integers(0, v, b).astype(np.int32)
    centers[:3] = centers[3]  # repeated centers: the row sums add several rows
    win = rng.integers(0, v, (b, 2 * w + 1)).astype(np.int32)
    vals = rng.random((b, 2 * w + 1)).astype(np.float32)
    return params, centers, win, vals


def test_deepsim_loss_and_gradients_match():
    params, centers, win, vals = _problem()
    jl, jg = jax.value_and_grad(jds.deepsim_loss)(
        tuple(jnp.asarray(p) for p in params), jnp.asarray(centers), jnp.asarray(win),
        jnp.asarray(vals))
    tp = [p.requires_grad_() for p in deepsim_params_from_numpy(params, "cpu")]
    tl = tds.deepsim_loss(tp, torch.from_numpy(centers), torch.from_numpy(win),
                          torch.from_numpy(vals))
    tl.backward()
    _close(tl.item(), float(jl))
    for p, g in zip(tp, jg):
        _close(p.grad.numpy(), np.asarray(g))


def _walks(v, n=24, length=12, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, v, (n, length)).astype(np.int32)
    walks[0, 7:] = -1  # a dead end
    walks[1, 3:] = -1
    return walks


def _jax_window(walks, table, wi, pos, k):
    """graphtpu's step body (models/deepsim.py:138-151) on given draws."""
    offs = jnp.arange(-k, k + 1)
    centers = walks[wi, pos]
    win = walks[wi[:, None], pos[:, None] + offs[None, :]]
    win = jnp.where(win >= 0, win, centers[:, None])
    vals = jds.lookup_sim(table, centers, win)
    dup = (win[:, :, None] == win[:, None, :]) & (
        jnp.arange(2 * k + 1)[None, :, None] > jnp.arange(2 * k + 1)[None, None, :])
    return centers, win, jnp.where(dup.any(axis=2), 0.0, vals)


def test_steps_match_optax_from_the_same_parameters():
    v, k, b = 40, 3, 16
    cfg = JDeepSimConfig(dim=8, window=k, minibatch=b)
    sims = _random_sims(5, v)
    jt, tt = _tables(sims, v)
    walks = _walks(v)
    jparams = jds.init_params(cfg, v, jax.random.key(0))
    opt = optax.adam(cfg.learning_rate)
    jstate = opt.init(jparams)
    jw = jnp.asarray(walks)

    @jax.jit
    def jstep(params, state, wi, pos):
        loss, grads = jax.value_and_grad(jds.deepsim_loss)(params, *_jax_window(jw, jt, wi, pos, k))
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    trainer = tds.Trainer(walks, tt, deepsim_params_from_numpy([np.asarray(p) for p in jparams],
                                                               "cpu"),
                          DeepSimConfig(dim=8, window=k, minibatch=b), 0, "cpu")
    model = trainer.model
    rng = np.random.default_rng(7)
    before = np.asarray(jparams[0])
    for step in range(20):
        wi = rng.integers(0, walks.shape[0], b).astype(np.int32)
        pos = rng.integers(k, walks.shape[1] - k, b).astype(np.int32)
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(wi), jnp.asarray(pos))
        loss = trainer.step(torch.from_numpy(wi), torch.from_numpy(pos))
        _close(loss.item(), float(jl))
        if step in (0, 1, 19):
            for got, want in zip(model.params(), jparams):
                _close(got.detach().numpy(), np.asarray(want))
        if step == 0:
            drawn0 = set((walks[wi, pos] % v).tolist())  # -1 reads the last row
            after0 = model.w1.detach().numpy().copy()
        if step == 1:
            # rows that moved at step 0 and were not drawn at step 1 move
            # again at step 1 through Adam's moments, under optax and here
            moved0 = set(np.flatnonzero(np.abs(after0 - before).max(axis=1) > 0).tolist())
            rows = sorted(moved0 - set((walks[wi, pos] % v).tolist()))
            assert rows and moved0 <= drawn0
            moved = np.abs(model.w1.detach().numpy()[rows] - after0[rows]).max(axis=1)
            assert (moved > 0).all()
            assert (np.abs(np.asarray(jparams[0])[rows] - after0[rows]).max(axis=1) > 0).all()
    untouched = np.abs(model.w1.detach().numpy() - before).max(axis=1) == 0
    assert not untouched[np.unique(walks[walks >= 0])].all()


def test_dead_end_center_reads_the_last_row_as_graphtpu_does():
    v, k = 40, 3
    _, tt = _tables(_random_sims(6, v), v)
    jt = jds.build_sim_table(_random_sims(6, v), v)
    walks = _walks(v)
    wi = np.array([0, 1, 2], np.int32)
    pos = np.array([8, 5, 4], np.int32)  # rows 0 and 1 are past their dead ends
    jc, jw, jv = _jax_window(jnp.asarray(walks), jt, jnp.asarray(wi), jnp.asarray(pos), k)
    tc, tw, tv = tds.window_batch(torch.from_numpy(walks), tt, torch.from_numpy(wi),
                                  torch.from_numpy(pos), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc) % v)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw) % v)
    assert tc[0].item() == v - 1


@pytest.mark.parametrize("steps,every", [(60, 30), (450, 0), (250, 300), (1000, 1000)])
def test_checkpoint_indices_match_graphtpu(steps, every):
    v = 6
    sims = {i: [((i + 1) % v, 0.5)] for i in range(v)}
    walks = np.tile(np.arange(v, dtype=np.int32), (4, 2))
    cfg = JDeepSimConfig(dim=2, window=1, minibatch=4)
    seen = []
    jds.train_deepsim(walks, jds.build_sim_table(sims, v), v, cfg, key=jax.random.key(0),
                      steps=steps, checkpoint_every=every,
                      checkpoint_fn=lambda i, e: seen.append(i))
    assert tds.checkpoint_steps(steps, every) == seen


def test_train_deepsim_calls_checkpoints_and_is_seeded():
    v = 12
    sims = {i: [((i + 1) % v, 0.5), ((i + 2) % v, 0.25)] for i in range(v)}
    table = tds.build_sim_table(sims, v)
    walks = torch.from_numpy(np.tile(np.arange(v, dtype=np.int32), (6, 2)))
    cfg = DeepSimConfig(dim=4, window=2, minibatch=8)
    seen, losses = [], []
    a = tds.train_deepsim(walks, table, v, cfg, key=3, steps=60, checkpoint_every=30,
                          checkpoint_fn=lambda i, e: seen.append((i, e.shape)), device="cpu",
                          losses=losses)
    b = tds.train_deepsim(walks, table, v, cfg, key=3, steps=60, device="cpu")
    assert seen == [(29, (v, 4)), (59, (v, 4))]
    assert len(losses) == 60 and np.isfinite(losses).all()
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="walk length"):
        tds.train_deepsim(walks[:, :4], table, v, cfg, steps=1, device="cpu")


def test_walks_cache_bytes_match(tmp_path):
    walks = _walks(30, n=10, length=9, seed=3)
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tpd.save_walks(a, torch.from_numpy(walks))
    jpd.save_walks(b, walks)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(tpd.load_walks(b, 9), jpd.load_walks(a, 9))
    np.testing.assert_array_equal(tpd.load_walks(a, 12), jpd.load_walks(a, 12))
    np.testing.assert_array_equal(tpd.load_walks(a, 5), jpd.load_walks(a, 5))


def test_read_simrank_and_diagnostics_match(tmp_path):
    from graphtpu_torch.io.simfile import write_sim_file

    rng = np.random.default_rng(4)
    v = 50
    edges = rng.integers(0, v, (200, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    labels = [[int(x) for x in rng.choice(4, rng.integers(0, 3), replace=False)] for _ in range(v)]
    sims = _random_sims(8, v)
    path = str(tmp_path / "s.sim.txt")
    idx = np.full((v, 8), -1, np.int32)
    val = np.zeros((v, 8), np.float32)
    for s, pairs in sims.items():
        pairs = sorted(pairs, key=lambda p: -p[1])
        idx[s, :len(pairs)] = [p[0] for p in pairs]
        val[s, :len(pairs)] = [p[1] for p in pairs]
    write_sim_file(path, idx, val)
    ts, js = tpd.read_simrank(path), jpd.read_simrank(path)
    assert ts == js
    for topk in (3, 10):
        assert tpd.simrank_label_agreement(ts, labels, topk) == \
            jpd.simrank_label_agreement(js, labels, topk)
    assert tpd.edge_label_homophily(build_graph(edges, n_nodes=v), labels) == \
        jpd.edge_label_homophily(j_build_graph(edges, n_nodes=v), labels)


def test_deepsim_pipeline_runs_and_caches_walks(tmp_path):
    from graphtpu_torch.core.config import WalkConfig
    from graphtpu_torch.io.simfile import write_sim_file

    v = 20
    edges = np.array([[i, (i + 1) % v] for i in range(v)] + [[i, (i + 5) % v] for i in range(v)])
    g = build_graph(edges, n_nodes=v)
    idx = np.array([[(i + 1) % v, (i + 2) % v] for i in range(v)], np.int32)
    path = str(tmp_path / "s.sim.txt")
    write_sim_file(path, idx, np.full((v, 2), 0.3, np.float32))
    cache = str(tmp_path / "walks.txt")
    kw = dict(cfg=DeepSimConfig(dim=4, window=2, minibatch=8),
              walk_cfg=WalkConfig(num_walks=2, walk_length=8), walks_cache=cache, seed=1,
              steps=5, device="cpu")
    times = {}
    a = tpd.deepsim_pipeline(g, path, stage_times=times, **kw)
    b = tpd.deepsim_pipeline(g, path, **kw)  # reads the cache
    assert list(times) == ["read", "walks", "train"]
    assert tpd.load_walks(cache, 8).shape == (2 * v, 8)
    assert a.shape == (v, 4) and np.array_equal(a, b)
