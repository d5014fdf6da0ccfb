"""graphtpu_torch's embedding path on an NVIDIA GPU: the edge set's probes
on the card against its host build, walks on the card valid, and SGNS's
determinism (segment_rows_sum and whole runs bit-equal).  Every test needs
a card and skips without one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_walks_cuda.py
"""

import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.kernels.edgeset import build_edge_set, device_edge_set, edge_set_contains
from graphtpu_torch.kernels.sampling import edge_exists
from graphtpu_torch.kernels.topk import segment_rows_sum
from graphtpu_torch.models.sgns import train_sgns
from graphtpu_torch.walks.node2vec import node2vec_walks
from graphtpu_torch.walks.walker import simulate_walks, uniform_walks

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _graph(v=500, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]  # v-1 isolated
    return gt.build_graph(edges, n_nodes=v)


@pytest.mark.parametrize("budget,mode", [(64 << 20, "bitmap"), (0, "cuckoo")])
def test_edge_set_probes_on_card_equal_host(cuda, budget, mode):
    g = _graph()
    host = build_edge_set(g, bitmap_byte_budget=budget)
    dev = host.to(cuda)
    assert dev.mode == mode
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.integers(-1, 500, size=(4096, 1)).astype(np.int32))
    v = torch.from_numpy(rng.integers(-1, 500, size=(1, 16)).astype(np.int32))
    want = edge_set_contains(host, u, v)
    got = edge_set_contains(dev, u.to(cuda), v.to(cuda))
    assert torch.equal(got.cpu(), want)
    rp, col, _, deg = g.host
    src = torch.from_numpy(np.repeat(np.arange(500, dtype=np.int32), deg)).to(cuda)
    assert bool(edge_set_contains(dev, src, torch.from_numpy(col).to(cuda)).all())


def _valid(g, walks):
    """Every transition of the walk tensor an edge (edge_exists on the card)
    and -1 from the first dead step on."""
    a, b = walks[:, :-1], walks[:, 1:]
    live = b >= 0
    assert bool(edge_exists(g, a[live], b[live]).all())
    dead = (walks < 0).int().cummax(dim=1).values.bool()
    assert bool((walks[dead] == -1).all())


@pytest.mark.parametrize("pq,mode", [((1.0, 1.0), "rejection"), ((1.0, 2.0), "rejection"),
                                     ((0.25, 0.25), "rejection"), ((0.5, 2.0), "exact")])
def test_walks_on_card_valid(cuda, pq, mode):
    g = _graph().to(cuda)
    walks = simulate_walks(g, 3, 20, 5, p=pq[0], q=pq[1], second_order_mode=mode, device=cuda)
    assert walks.device.type == "cuda" and walks.dtype == torch.int32
    assert walks.shape == (3 * 499, 20)
    _valid(g, walks)


def test_cuckoo_walks_and_sorted_walks_on_card_valid(cuda):
    g = _graph(v=30_000, e=90_000).to(cuda)
    assert device_edge_set(g).mode == "cuckoo"
    starts = torch.arange(0, 30_000, 7, dtype=torch.int32, device=cuda)
    _valid(g, node2vec_walks(g, starts, 12, 1.0, 2.0, 3, device=cuda))
    _valid(g, node2vec_walks(g, starts, 12, 1.0, 2.0, 3, sort_gather=True, device=cuda))
    _valid(g, uniform_walks(g, starts, 12, 3, sort_gather=True, device=cuda))


def test_segment_rows_sum_bit_identical_across_calls(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    idx = torch.randint(-1, 700, (200_000,), generator=gen, device=cuda)
    rows = torch.randn((200_000, 128), generator=gen, device=cuda)
    first = segment_rows_sum(idx, rows, 700)
    for _ in range(2):
        again = segment_rows_sum(idx, rows, 700)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    want = torch.zeros((701, 128), dtype=torch.float64, device=cuda)
    want.index_add_(0, torch.where(idx >= 0, idx, 700), rows.double())
    torch.testing.assert_close(first[0].double(), want[:700], rtol=0, atol=1e-3)


def test_sgns_runs_bit_equal_on_card(cuda):
    g = _graph().to(cuda)
    walks = simulate_walks(g, 4, 20, 1, p=1.0, q=2.0, device=cuda)
    cfg = SGNSConfig(dim=32, window=4, epochs=2, batch_size=256, subsample=1e-2)
    a = train_sgns(walks, g.n_nodes, cfg, chunk_steps=7, device=cuda)
    b = train_sgns(walks, g.n_nodes, cfg, chunk_steps=7, device=cuda)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.isfinite(a[0]).all()


def test_captured_steps_equal_the_eager_steps(cuda, monkeypatch):
    """train_sgns on the card replays one captured CUDA graph a step: the
    same bits, and the same counts, as the same steps taken eagerly, over
    epochs (the compacted walks copied in) and chunks (the stream
    reseeded)."""
    from graphtpu_torch.models import sgns

    g = _graph().to(cuda)
    walks = simulate_walks(g, 4, 20, 1, p=0.25, q=0.25, device=cuda)
    cfg = SGNSConfig(dim=32, window=4, epochs=2, batch_size=256, subsample=1e-2)
    before = dict(sgns.SGNS_COUNTS)
    graphed = train_sgns(walks, g.n_nodes, cfg, chunk_steps=7, device=cuda)
    counted = {k: sgns.SGNS_COUNTS[k] - before[k] for k in before}

    class Eager(sgns.SgnsSteps):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.graphed = False

    monkeypatch.setattr(sgns, "SgnsSteps", Eager)
    before = dict(sgns.SGNS_COUNTS)
    eager = train_sgns(walks, g.n_nodes, cfg, chunk_steps=7, device=cuda)
    assert {k: sgns.SGNS_COUNTS[k] - before[k] for k in before} == counted
    assert counted["steps"] == 2 * (walks.numel() // 256) and counted["pairs"] > 0
    assert np.array_equal(graphed[0], eager[0]) and np.array_equal(graphed[1], eager[1])
