"""graphtpu_torch's host-side graph API on an NVIDIA GPU: a graph whose
tensors live on the card answers ``neighbors``/``degree``, ``bfs_order``
and ``locality_score`` from its host mirror, equal to its card CSR.  Every
test needs a card and skips without one.  This file imports neither jax
nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py
"""

import numpy as np
import pytest
import torch

import graphtpu_torch as gt
from graphtpu_torch.core.reorder import bfs_order, locality_score

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _edges(v=500, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges[(edges[:, 0] != v - 1) & (edges[:, 1] != v - 1)]  # v-1 isolated


@pytest.mark.parametrize("dedup", [True, False])
def test_neighbors_and_degree_on_card_equal_csr(cuda, dedup):
    g = gt.build_graph(_edges(), n_nodes=500, dedup=dedup, device=cuda)
    assert g.device.type == "cuda"
    rp, col, deg = (t.cpu().numpy() for t in (g.row_ptr, g.col, g.deg))
    for v in range(g.n_nodes):
        nb = g.neighbors(v)
        assert nb.dtype == np.int32
        np.testing.assert_array_equal(nb, col[rp[v]: rp[v + 1]])
        assert g.degree(v) == int(deg[v])
    dg = gt.build_graph(_edges(seed=1), n_nodes=500, directed=True, dedup=dedup, device=cuda)
    assert (dg.n_nodes, dg.n_edges) == (500, int(dg.out.col.numel()))


def test_bfs_order_and_locality_on_card_equal_cpu(cuda):
    edges = _edges()
    g_cpu = gt.build_graph(edges, n_nodes=500)
    g = gt.build_graph(edges, n_nodes=500, device=cuda)
    for start in (None, 0, int(np.argmax(g.host[3])), 499):
        np.testing.assert_array_equal(bfs_order(g, start=start), bfs_order(g_cpu, start=start))
    for window in (0, 1, 2, 5):
        hits = int((torch.diff(g.col.long()).abs() <= window).sum())
        assert locality_score(g, window=window) == locality_score(g_cpu, window=window)
        assert locality_score(g, window=window) == pytest.approx(hits / (g.n_edges - 1), abs=1e-12)
