"""graphtpu_torch's Monte-Carlo SimRank engines against graphtpu's.

The two packages draw different random numbers (threefry against Philox),
so every deterministic piece is fed the same input in both and compared
exactly or to a stated float32 tolerance: the items of injected walks,
the reuse estimators on injected walks, the even-split frontier, full
enumeration, the meeting-probability products and the step-1 endpoint
products.  The sampled engines are compared statistically: each package's
top-10 precision against exact SimRank within 0.05 of the other's, and
each estimate's mean absolute error within 1.5x of the other's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
from graphtpu.core.config import DoubleWalkConfig as JDoubleWalkConfig
from graphtpu.core.config import SimRankConfig as JSimRankConfig
from graphtpu.core.config import TopSimConfig as JTopSimConfig
from graphtpu.core.config import UniWalkConfig as JUniWalkConfig
from graphtpu.simrank import doublewalk as jdw
from graphtpu.simrank import meeting as jm
from graphtpu.simrank import topsim as jts
from graphtpu.simrank import uniwalk as ju
from graphtpu.simrank.exact import exact_simrank as j_exact_simrank
from graphtpu.walks.walker import uniform_walks as j_uniform_walks
from graphtpu_torch.bench.sweep import gold_standard, sim_matrix_to_dict
from graphtpu_torch.core.config import DoubleWalkConfig, TopSimConfig, UniWalkConfig
from graphtpu_torch.core.graph import graph_from_numpy
from graphtpu_torch.eval.precision import precision_sim_dicts
from graphtpu_torch.simrank import doublewalk as tdw
from graphtpu_torch.simrank import meeting as tm
from graphtpu_torch.simrank import topsim as tts
from graphtpu_torch.simrank import uniwalk as tu

torch.set_num_threads(1)
CPU = "cpu"
TOL = 1e-6       # float32 results of the same operations, possibly in another order
ITEM_TOL = 1e-7  # one item's value: the same four float32 operations


def _port(jg):
    """The port's graph on graphtpu's CSR arrays."""
    w = None if jg.weight is None else np.asarray(jg.weight)
    return graph_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col), w, np.asarray(jg.deg))


@pytest.fixture(scope="module")
def small(small_random):
    return small_random, _port(small_random)


@pytest.fixture(scope="module")
def ring(ring16):
    return ring16, _port(ring16)


@pytest.fixture(scope="module")
def low_degree():
    """20 nodes, a ring with chords: degrees 2-4, so step-2 enumeration and
    an even split at budget 1e5 stay small."""
    edges = [[i, (i + 1) % 20] for i in range(20)] + [[0, 7], [3, 12], [5, 15], [9, 18], [0, 11]]
    jg = graphtpu.build_graph(np.array(edges), n_nodes=20)
    return jg, _port(jg)


def _assert_ranked(vals, idx, ref_vals, ref_idx, truth, tol):
    """vals within tol of ref_vals; at each position the two ids' true
    scores within tol (equal ids where no near-tie)."""
    np.testing.assert_allclose(vals, ref_vals, rtol=0, atol=tol)
    for r in range(vals.shape[0]):
        for a, b in zip(idx[r], ref_idx[r]):
            if a != b:
                assert a >= 0 and b >= 0 and abs(truth[r, a] - truth[r, b]) <= tol, (r, a, b)


def _walk_tile(jg, sources, sample, step, seed):
    starts = jnp.repeat(jnp.asarray(sources, jnp.int32), sample)
    w = np.asarray(j_uniform_walks(jg, starts, 2 * step, jax.random.key(seed)))
    w = w.reshape(len(sources), sample, 2 * step + 1).copy()
    w[0, :10, 4:] = -1  # dead ends from hop 4 on
    return w


def test_tile_items_match(small):
    jg, tg = small
    walks = _walk_tile(jg, np.arange(8), 50, 3, 3)
    jt, jv = ju._tile_items(jg.deg, jnp.asarray(walks), 3, 0.6, 50)
    tt, tv = tu._tile_items(tg.deg, torch.from_numpy(walks), 3, 0.6, 50)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=ITEM_TOL, atol=0)
    dense_j = ju._tile_increments(jg.deg, 64, jnp.asarray(walks), 3, 0.6, 50)
    dense_t = tu._tile_increments(tg.deg, 64, torch.from_numpy(walks), 3, 0.6, 50)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), rtol=0, atol=TOL)


def _reuse_walks(jg, cfg, seed):
    times = cfg.reuse_times
    starts = jnp.repeat(jnp.arange(jg.n_nodes, dtype=jnp.int32), cfg.sample // times)
    return np.array(j_uniform_walks(jg, starts, 2 * cfg.step + times - 1, jax.random.key(seed)))


def test_reuse_items_match(small):
    jg, tg = small
    walks = _reuse_walks(jg, JUniWalkConfig(sample=12, step=3, reuse_times=3), 4)
    walks[:20, 5:] = -1
    js = ju._reuse_items(jg.deg, jnp.asarray(walks), 3, 0.6, 3)
    ts = tu._reuse_items(tg.deg, torch.from_numpy(walks), 3, 0.6, 3)
    for k in (0, 1, 3):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    np.testing.assert_allclose(ts[2].numpy(), np.asarray(js[2]), rtol=ITEM_TOL, atol=0)


def test_uniwalk_reuse_dense_and_topk_match(small):
    """Both reuse estimators fed graphtpu's walks: dense to 1e-6, and the
    sort-based top-k against graphtpu's and against the port's scatter
    oracle."""
    jg, tg = small
    jcfg = JUniWalkConfig(sample=40, step=2, reuse_times=4, topk=10)
    cfg = UniWalkConfig(sample=40, step=2, reuse_times=4, topk=10)
    walks = _reuse_walks(jg, jcfg, 5)
    j_dense = ju.uniwalk_simrank_reuse(jg, jcfg, walks=jnp.asarray(walks))
    t_dense = tu.uniwalk_simrank_reuse(tg, cfg, walks=walks, device=CPU)
    np.testing.assert_allclose(t_dense, j_dense, rtol=0, atol=TOL)
    tv, ti = tu.uniwalk_simrank_reuse_topk(tg, cfg, walks=torch.from_numpy(walks), device=CPU)
    order = np.argsort(-t_dense, axis=1, kind="stable")[:, :10]
    _assert_ranked(tv, ti, np.take_along_axis(t_dense, order, 1), order, t_dense, TOL)
    # graphtpu's totals come from one float32 prefix over the whole stream,
    # so they round at the scale of its mass (over each source's count)
    jv, ji = ju.uniwalk_simrank_reuse_topk(jg, jcfg, walks=jnp.asarray(walks))
    srcs, _, vals, cnt = ju._reuse_items(jg.deg, jnp.asarray(walks), 2, 0.6, 4)
    mass = float(np.asarray(vals)[np.asarray(srcs) >= 0].sum())
    counts = np.bincount(np.asarray(cnt)[np.asarray(cnt) >= 0], minlength=64)
    tol = 4 * np.finfo(np.float32).eps * mass / np.maximum(counts, 1)
    for r in range(64):
        _assert_ranked(tv[r:r + 1], ti[r:r + 1], np.asarray(jv)[r:r + 1],
                       np.asarray(ji)[r:r + 1], t_dense[r:r + 1], tol[r])


def test_uniwalk_topk_matches_its_dense_tiles(small):
    """One key, so the same walks: the sort-based tiles give the dense
    tiles' top-k, with a padded last tile."""
    _, tg = small
    cfg = UniWalkConfig(sample=300, step=3, topk=8, source_tile=4)
    sources = np.array([5, 1, 9, 33, 60, 2, 17, 40, 8, 11], np.int32)
    vals, idx = tu.uniwalk_simrank(tg, cfg, key=7, sources=sources, device=CPU)
    dense = tu.uniwalk_simrank(tg, cfg, key=7, sources=sources, dense=True, device=CPU)
    assert dense.shape == (10, 64) and (dense[np.arange(10), sources] == 0).all()
    order = np.argsort(-dense, axis=1, kind="stable")[:, :8]
    _assert_ranked(vals, idx, np.take_along_axis(dense, order, 1), order, dense, TOL)
    v2, i2 = tu.uniwalk_simrank(tg, cfg, key=7, sources=sources, device=CPU)
    np.testing.assert_array_equal(v2, vals)
    np.testing.assert_array_equal(i2, idx)


def test_expand_frontier_even_split_matches(small):
    """Budget >= degree everywhere: every parent splits evenly, so the
    frontier is deterministic and equal in both packages."""
    jg, tg = small
    t, w, length = 3, 4096, 5
    paths = np.full((t, w, length), -1, np.int32)
    paths[:, 0, 0] = [0, 17, 42]
    mass = np.zeros((t, w), np.float32)
    mass[:, 0] = 1e6
    jp, jmass = jnp.asarray(paths), jnp.asarray(mass)
    tp, tmass = torch.from_numpy(paths), torch.from_numpy(mass)
    for depth in range(3):
        jp, jmass, _ = jts._expand_frontier(jg, jp, jmass, depth, jax.random.key(depth))
        tp, tmass, dropped = tts._expand_frontier(tg, tp, tmass, depth, depth)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tmass.numpy(), np.asarray(jmass))
        assert (dropped == 0).all()
    assert (tmass > 0).sum() > 1000


@pytest.mark.parametrize("which,step", [("ring", 3), ("low_degree", 2)])
def test_topsim_enumerate_matches(which, step, request):
    jg, tg = request.getfixturevalue(which)
    jcfg = JTopSimConfig(step=step, sample=10.0, topk=6, source_tile=8, enumerate_all=True)
    cfg = TopSimConfig(step=step, sample=10.0, topk=6, source_tile=8, enumerate_all=True)
    j_dense = jts.topsim_simrank(jg, jcfg, dense=True)
    stats = {}
    t_dense = tts.topsim_simrank(tg, cfg, dense=True, device=CPU, stats=stats)
    np.testing.assert_allclose(t_dense, j_dense, rtol=0, atol=TOL)
    assert stats["dropped_mass"] == 0.0
    jv, ji = jts.topsim_simrank(jg, jcfg)
    tv, ti = tts.topsim_simrank(tg, cfg, device=CPU)
    _assert_ranked(tv, ti, np.asarray(jv), np.asarray(ji), t_dense, TOL)


def test_topsim_enumerate_overflow_reports_dropped_mass(low_degree):
    """A frontier of 12 slots cannot hold step-2 enumeration: the children
    past the last slot are dropped in both packages alike, and the port
    reports their mass."""
    jg, tg = low_degree
    kw = dict(step=2, sample=10.0, topk=6, source_tile=8, enumerate_all=True,
              frontier_capacity=12)
    j_dense = jts.topsim_simrank(jg, JTopSimConfig(**kw), dense=True)
    stats = {}
    t_dense = tts.topsim_simrank(tg, TopSimConfig(**kw), dense=True, device=CPU, stats=stats)
    np.testing.assert_allclose(t_dense, j_dense, rtol=0, atol=TOL)
    assert stats["dropped_mass"] > 0


def test_topsim_enumerate_bound_raises(small):
    _, tg = small
    with pytest.raises(ValueError, match="frontier bound"):
        tts.topsim_simrank(tg, TopSimConfig(step=3, enumerate_all=True), device=CPU)


def test_topsim_sample_topk_matches_dense(small):
    _, tg = small
    cfg = TopSimConfig(sample=300.0, step=3, topk=8, source_tile=16)
    stats = {}
    vals, idx = tts.topsim_simrank(tg, cfg, key=2, device=CPU, stats=stats)
    dense = tts.topsim_simrank(tg, cfg, key=2, dense=True, device=CPU)
    order = np.argsort(-dense, axis=1, kind="stable")[:, :8]
    _assert_ranked(vals, idx, np.take_along_axis(dense, order, 1), order, dense, TOL)
    assert stats["dropped_mass"] == 0.0


def test_doublesample_similarity_matches(small):
    jg, tg = small
    j = jm.doublesample_similarity(jg, JTopSimConfig(step=3), matmul_precision="highest")
    t = tm.doublesample_similarity(tg, TopSimConfig(step=3), device=CPU)
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


def test_topsim_dev_matches(low_degree):
    """Phase 1 is deterministic here (an even split everywhere: budget 1e5
    over degrees <= 4 for 4 hops), and single_k covers every reachable
    node, so both packages verify the same candidates."""
    jg, tg = low_degree
    kw = dict(step=2, sample=1e5, topk=5, source_tile=8, frontier_capacity=512)
    jv, ji = jm.topsim_dev(jg, JTopSimConfig(**kw), single_k=20)
    tv, ti = tm.topsim_dev(tg, TopSimConfig(**kw), single_k=20, device=CPU)
    truth = tm.doublesample_similarity(tg, TopSimConfig(**kw), device=CPU)
    _assert_ranked(tv, ti, np.asarray(jv), np.asarray(ji), truth, TOL)
    sources = np.array([3, 0, 19], np.int32)
    sv, si = tm.topsim_dev(tg, TopSimConfig(**kw), single_k=20, sources=sources, device=CPU)
    np.testing.assert_array_equal(sv, tv[sources])


@pytest.mark.parametrize("s_active", [7, 20])
def test_step1_mass_sim_matches(s_active):
    rng = np.random.default_rng(8)
    v, s = 30, 20
    ends = rng.integers(-1, v, size=(v, s)).astype(np.int32)
    sources = np.array([0, 4, 29, 11], np.int32)
    j = np.asarray(jdw.step1_mass_sim(jnp.asarray(ends), jnp.asarray(sources), v, 0.6,
                                      jnp.int32(s_active)))
    t = tdw.step1_mass_sim(torch.from_numpy(ends), torch.from_numpy(sources), v, 0.6,
                           s_active).numpy()
    np.testing.assert_array_equal(t, j)


def test_doublewalk_rows_step1_is_the_histogram_product(small):
    """At step 1 the rows form is the pair-loop estimator: on one key both
    see the same walks."""
    _, tg = small
    cfg = DoubleWalkConfig(sample=30, step=1, source_tile=16)
    rows = tdw.doublewalk_simrank_rows(tg, cfg, key=3, device=CPU)
    dense = tdw.doublewalk_simrank(tg, cfg, key=3, device=CPU)
    np.testing.assert_allclose(rows, dense, rtol=0, atol=TOL)
    sources = np.array([9, 2], np.int32)
    sub = tdw.doublewalk_simrank_rows(tg, DoubleWalkConfig(sample=30, step=2, source_tile=16),
                                      key=3, sources=sources, device=CPU)
    full = tdw.doublewalk_simrank(tg, DoubleWalkConfig(sample=30, step=2, source_tile=16),
                                  key=3, device=CPU)
    np.testing.assert_allclose(sub, full[sources], rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def gold_small(small_random):
    return np.asarray(j_exact_simrank(small_random, JSimRankConfig(iterations=5)))


def _quality(est, gold):
    """(top-10 precision against gold, mean absolute error off the diagonal)."""
    off = ~np.eye(gold.shape[0], dtype=bool)
    p = precision_sim_dicts(sim_matrix_to_dict(gold, 10), sim_matrix_to_dict(est, 10), k=10)
    return p, float(np.abs(est - gold)[off].mean())


def _assert_parity(jq, tq):
    assert abs(jq[0] - tq[0]) <= 0.05, (jq, tq)
    assert tq[1] <= 1.5 * jq[1] and jq[1] <= 1.5 * tq[1], (jq, tq)


def test_uniwalk_statistical_parity(small, gold_small):
    jg, tg = small
    kw = dict(sample=4000, step=3, source_tile=64)
    j = ju.uniwalk_simrank(jg, JUniWalkConfig(**kw), dense=True)
    t = tu.uniwalk_simrank(tg, UniWalkConfig(**kw), dense=True, device=CPU)
    _assert_parity(_quality(j, gold_small), _quality(t, gold_small))


def test_topsim_statistical_parity(small, gold_small):
    jg, tg = small
    kw = dict(sample=400.0, step=3, source_tile=64)
    j = jts.topsim_simrank(jg, JTopSimConfig(**kw), dense=True)
    t = tts.topsim_simrank(tg, TopSimConfig(**kw), dense=True, device=CPU)
    _assert_parity(_quality(j, gold_small), _quality(t, gold_small))


def test_doublewalk_statistical_parity(small, gold_small):
    jg, tg = small
    kw = dict(sample=60, step=3, source_tile=32)
    j = jdw.doublewalk_simrank(jg, JDoubleWalkConfig(**kw))
    t = tdw.doublewalk_simrank(tg, DoubleWalkConfig(**kw), device=CPU)
    _assert_parity(_quality(j, gold_small), _quality(t, gold_small))


@pytest.mark.parametrize("entry", [
    lambda g: tu.uniwalk_simrank(g),
    lambda g: tu.uniwalk_simrank_reuse(g),
    lambda g: tu.uniwalk_simrank_reuse_topk(g),
    lambda g: tts.topsim_simrank(g),
    lambda g: tdw.doublewalk_simrank(g),
    lambda g: tdw.doublewalk_simrank_rows(g),
    lambda g: tm.doublesample_similarity(g),
    lambda g: tm.doublesample_similarity_mc(g, 5),
    lambda g: tm.topsim_dev(g),
    lambda g: gold_standard(g),
], ids=["uniwalk", "reuse", "reuse_topk", "topsim", "doublewalk", "doublewalk_rows",
        "doublesample", "doublesample_mc", "topsim_dev", "gold_standard"])
def test_entry_points_need_a_card(entry, ring, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(ring[1])
