"""graphtpu_torch's Monte-Carlo SimRank engines on an NVIDIA GPU: the
sort-based accumulators on the card against the CPU, the reuse top-k
against its scatter oracle, full enumeration on the card against the CPU,
and runs with one seed bit-equal.  Every test needs a card and skips
without one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_mc_cuda.py
"""

import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.core.config import TopSimConfig, UniWalkConfig
from graphtpu_torch.kernels import topk as ttk
from graphtpu_torch.simrank import doublewalk as tdw
from graphtpu_torch.simrank import meeting as tm
from graphtpu_torch.simrank import topsim as tts
from graphtpu_torch.simrank import uniwalk as tu
from graphtpu_torch.walks.walker import uniform_walks

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
PARITY = 1e-5  # reuse top-k against the dense scatter oracle (float adds in any order)
TOL = 1e-6     # the same float32 operations on the card and the CPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _graph(v=300, e=2400, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    return gt.build_graph(edges[edges[:, 0] != edges[:, 1]], n_nodes=v)


def _items(seed, shape, n_classes, quantised):
    rng = np.random.default_rng(seed)
    tg = rng.integers(-1, n_classes, size=shape).astype(np.int32)
    v = rng.integers(1, 5, size=shape) / 4 if quantised else rng.random(shape)
    return torch.from_numpy(tg), torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("quantised", [True, False])
def test_segment_topk_card_equals_cpu(cuda, quantised):
    tg, v = _items(0, (64, 5000), 900, quantised)
    cv, ci = ttk.segment_topk(tg, v, 20, 900)
    gv, gi = ttk.segment_topk(tg.to(cuda), v.to(cuda), 20, 900)
    if quantised:  # float64 sums of quarters are exact: the same bits
        assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)
    else:
        torch.testing.assert_close(gv.cpu(), cv, rtol=TOL, atol=0)


@pytest.mark.parametrize("quantised", [True, False])
def test_pair_topk_by_source_card_equals_cpu(cuda, quantised):
    s, _ = _items(1, (200_000,), 700, quantised)
    t, v = _items(2, (200_000,), 900, quantised)
    counts = torch.from_numpy(np.random.default_rng(3).integers(0, 9, 700).astype(np.float32))
    ids = torch.arange(0, 710, 3)
    cv, ci = ttk.pair_topk_by_source(s, t, v, ids, 20, counts=counts)
    gv, gi = ttk.pair_topk_by_source(s.to(cuda), t.to(cuda), v.to(cuda), ids.to(cuda), 20,
                                     counts=counts.to(cuda))
    if quantised:
        assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)
    else:
        torch.testing.assert_close(gv.cpu(), cv, rtol=TOL, atol=0)
    assert (gi[ids >= 700].cpu() == -1).all()


def test_segment_sum_and_bounded_card_equal_cpu(cuda):
    ids, vals = _items(4, (100_000,), 500, True)
    assert torch.equal(ttk.segment_sum_1d(ids.to(cuda), vals.to(cuda), 510).cpu(),
                       ttk.segment_sum_1d(ids, vals, 510))
    keys, v = _items(5, (32, 200), 40, True)
    ck, cv = ttk.bounded_topk_accumulate(keys, v, 8)
    gk, gv = ttk.bounded_topk_accumulate(keys.to(cuda), v.to(cuda), 8)
    assert torch.equal(gk.cpu(), ck) and torch.equal(gv.cpu(), cv)


def test_reuse_topk_matches_scatter_oracle_on_card(cuda):
    """The sort-based accumulator against the dense scatter, fed the same
    walks on the card."""
    g = _graph()
    cfg = UniWalkConfig(sample=400, step=5, reuse_times=4, topk=20)
    starts = torch.repeat_interleave(torch.arange(300, dtype=torch.int32, device=cuda), 100)
    walks = uniform_walks(g, starts, 2 * 5 + 3, 9, device=cuda)
    vals, idx = tu.uniwalk_simrank_reuse_topk(g, cfg, walks=walks, device=cuda)
    dense = tu.uniwalk_simrank_reuse(g, cfg, walks=walks, device=cuda)
    order = np.argsort(-dense, axis=1, kind="stable")[:, :20]
    np.testing.assert_allclose(vals, np.take_along_axis(dense, order, 1), rtol=0, atol=PARITY)
    for r in range(300):
        for a, b in zip(idx[r], order[r]):
            assert a == b or abs(dense[r, a] - dense[r, b]) <= PARITY, (r, a, b)


def test_topsim_enumerate_card_equals_cpu(cuda):
    """No randomness: the dense enumerate matrix on the card is the CPU's."""
    rng = np.random.default_rng(6)
    edges = np.array([[i, (i + 1) % 60] for i in range(60)]
                     + [[int(a), int(b)] for a, b in rng.integers(0, 60, (40, 2)) if a != b])
    g = gt.build_graph(edges, n_nodes=60)
    assert g.max_degree <= 7
    cfg = TopSimConfig(step=3, sample=10.0, topk=10, source_tile=4, enumerate_all=True)
    sources = np.array([0, 7, 33, 59, 12], np.int32)
    cpu = tts.topsim_simrank(g, cfg, sources=sources, dense=True, device="cpu")
    card = tts.topsim_simrank(g, cfg, sources=sources, dense=True, device=cuda)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=TOL)


def test_runs_with_one_seed_bit_equal(cuda):
    g = _graph()
    cfg = UniWalkConfig(sample=2000, step=5, topk=20, source_tile=64)
    a = tu.uniwalk_simrank(g, cfg, key=3, device=cuda)
    b = tu.uniwalk_simrank(g, cfg, key=3, device=cuda)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    tcfg = TopSimConfig(sample=500.0, step=3, topk=20, source_tile=32)
    stats = {}
    a = tts.topsim_simrank(g, tcfg, key=3, device=cuda, stats=stats)
    b = tts.topsim_simrank(g, tcfg, key=3, device=cuda)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert stats["dropped_mass"] == 0.0


def test_uniwalk_topk_equals_its_dense_tiles_on_card(cuda):
    g = _graph()
    cfg = UniWalkConfig(sample=1000, step=3, topk=10, source_tile=40)
    vals, idx = tu.uniwalk_simrank(g, cfg, key=5, device=cuda)
    dense = tu.uniwalk_simrank(g, cfg, key=5, dense=True, device=cuda)
    order = np.argsort(-dense, axis=1, kind="stable")[:, :10]
    np.testing.assert_allclose(vals, np.take_along_axis(dense, order, 1), rtol=0, atol=PARITY)


def test_histogram_products_card_equal_cpu(cuda):
    rng = np.random.default_rng(7)
    ends = torch.from_numpy(rng.integers(-1, 300, (300, 64)).astype(np.int32))
    src = torch.arange(0, 300, 7, dtype=torch.int32)
    cpu = tdw.step1_mass_sim(ends, src, 300, 0.6, 50)
    card = tdw.step1_mass_sim(ends.to(cuda), src.to(cuda), 300, 0.6, 50)
    assert torch.equal(card.cpu(), cpu)  # integer products in full fp32 are exact
    g = _graph()
    np.testing.assert_allclose(tm.doublesample_similarity(g, device=cuda),
                               tm.doublesample_similarity(g, device="cpu"), rtol=0, atol=TOL)
