"""TopSim's frontier expansion TS1 (``kernels/csrc/expand.cu``) on an NVIDIA
GPU against its plain version (``simrank/topsim.py:_expand_frontier_plain``)
on the same card: the same frontier and keys at every depth of a spread
give the same paths and masses bit for bit, and the dropped mass within a
float32 summation tolerance; at the TopSim cell's SAMPLE and W over a
group of tiles, with W cut to SAMPLE (mass overflows), with
``enumerate_all`` (W 3,000, which overflows, and 65,536), on a
Kronecker graph with isolated nodes and under ``readings_topsim.sampled``;
a whole solve equals the plain version's; and a solve counts 2·STEP
launches a group.  Every test needs a card and skips without one.  This
file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_expand_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import readings_topsim
from benchmark.gen.graphs import kron, urand
from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.simrank import topsim as ts

pytestmark = pytest.mark.cuda

# A row's dropped mass is a float32 sum over its W parents: the plain
# version's reduction and the kernel's (a thread's 4 parents in each of 20
# chunks, a warp tree, 8 warp totals) add in other orders, each within ~100
# roundings of 2^-24 (6e-6) of the row's total.
DROP_RTOL = 1e-5
KEY = 2**45 + 17
CELL = TopSimConfig(sample=10_000.0, step=3, topk=20)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32)


def _spread_both(g, src, cap, step, sample, key, enumerate_all=False, tile=32):
    """Spread ``src`` with the plain version, holding the kernel to it on the
    same input at every depth; returns (the kernel's launches, the dropped
    mass, the live slots at the last depth)."""
    dev = g.device
    t = len(src)
    paths = torch.full((t, cap, 2 * step + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0, 0] = torch.as_tensor(src, dtype=torch.int32, device=dev)
    mass = torch.zeros((t, cap), dtype=torch.float32, device=dev)
    mass[:, 0] = sample
    tile_keys = [key_for(key, lo) for lo in range(0, t, tile)]
    before = ts.EXPAND_LAUNCHES["expand"]
    lost = 0.0
    for depth in range(2 * step):
        keys = [key_for(k, depth) for k in tile_keys]
        got = ts._expand_frontier(g, paths, mass, depth, keys, enumerate_all)
        want = ts._expand_frontier_plain(g, paths, mass, depth, keys, enumerate_all)
        assert torch.equal(got[0], want[0]), f"paths differ at depth {depth}"
        assert torch.equal(_bits(got[1]), _bits(want[1])), f"mass differs at depth {depth}"
        torch.testing.assert_close(got[2], want[2], rtol=DROP_RTOL, atol=0.0)
        lost += float(want[2].sum())
        paths, mass = want[0], want[1]
    return ts.EXPAND_LAUNCHES["expand"] - before, lost, int((mass > 0).sum())


@pytest.fixture(scope="module")
def cell_graph(dev):
    return build_graph(urand(11, 15, 16), n_nodes=1 << 15, device=dev)


def test_cell_shape_group_bit_equal(cell_graph):
    """The cell's SAMPLE 10,000 and W 20,008, four tiles of 32 sources side
    by side, each on its own keys: no mass dropped."""
    cap = ts.frontier_capacity(cell_graph, CELL)
    assert cap == 20_008
    launches, lost, live = _spread_both(cell_graph, list(range(1000, 1128)), cap, 3,
                                        CELL.sample, KEY)
    assert launches == 6 and lost == 0.0 and live > 0


def test_w_cut_to_sample_drops_mass(cell_graph):
    launches, lost, _ = _spread_both(cell_graph, list(range(64)), 10_000, 3, CELL.sample,
                                     KEY + 1)
    assert launches == 6 and lost > 0


@pytest.mark.parametrize("cap", [3_000, 65_536])
def test_enumerate_all_small_graph(dev, cap):
    """Every active parent splits: W 3,000 overflows, W 65,536 holds every
    child at 64 chunks of parents a row."""
    g = build_graph(urand(3, 6, 2), n_nodes=64, device=dev)
    assert g.max_degree ** 4 <= cap or cap == 3_000
    launches, _, live = _spread_both(g, list(range(8)), cap, 2, 1.0, KEY, enumerate_all=True,
                                     tile=4)
    assert launches == 4 and live > 0


def test_kron_isolated_nodes_and_a_hub(dev):
    """Isolated sources die at depth 0; the hub (degree 1,343) splits its
    2,000 over children that fill several rounds of slots."""
    g = build_graph(kron(4, 12, 16, (0.57, 0.19, 0.19, 0.05)), n_nodes=1 << 12, device=dev)
    alone = torch.nonzero(g.deg == 0).flatten()[:16].tolist()
    hub = int(g.deg.argmax())
    assert len(alone) == 16 and g.max_degree > 1_024
    src = alone + [hub] + list(range(47))
    launches, lost, live = _spread_both(g, src, 2 * 2_000 + 8, 3, 2_000.0, KEY)
    assert launches == 6 and lost == 0.0 and live > 0


def test_sampled_control(cell_graph):
    """Under the control the kernel sees the raised degrees for its rule and
    draws from ``row_ptr``, as the plain version draws from the graph's
    own degrees with ``neighbor_at`` replaced."""
    g = cell_graph
    raised = dataclasses.replace(g, deg=g.deg + (1 << 30))
    draw = ts.neighbor_at
    t, cap = 64, 20_008
    paths = torch.full((t, cap, 7), -1, dtype=torch.int32, device=g.device)
    paths[:, 0, 0] = torch.arange(t, dtype=torch.int32, device=g.device)
    mass = torch.zeros((t, cap), dtype=torch.float32, device=g.device)
    mass[:, 0] = CELL.sample
    for depth in range(6):
        keys = [key_for(KEY, 0, depth), key_for(KEY, 32, depth)]
        with readings_topsim.sampled():
            got = ts._expand_frontier(g, paths, mass, depth, keys)
        ts.neighbor_at = lambda _, cur, u: draw(g, cur, u)
        try:
            want = ts._expand_frontier_plain(raised, paths, mass, depth, keys)
        finally:
            ts.neighbor_at = draw
        assert torch.equal(got[0], want[0]) and torch.equal(_bits(got[1]), _bits(want[1]))
        paths, mass = want[0], want[1]
    assert ts.neighbor_at is draw and int((mass > 0).sum()) > 0


def test_solve_equals_the_plain_solve_and_counts_launches(dev, monkeypatch):
    """One ``topsim_simrank`` call launches TS1 2·STEP times a group, and
    its answers equal those of the same call on the plain expansion."""
    g = build_graph(urand(5, 10, 16), n_nodes=1024, device=dev)
    before = ts.EXPAND_LAUNCHES["expand"]
    vals, idx = ts.topsim_simrank(g, CELL, key=KEY, device=dev)
    launches = ts.EXPAND_LAUNCHES["expand"] - before
    cap = ts.frontier_capacity(g, CELL)
    tiles = 1024 // CELL.source_tile
    groups = -(-tiles // max(1, ts.GROUP_SLOTS // (CELL.source_tile * cap)))
    assert groups == 2 and launches == 2 * CELL.step * groups
    monkeypatch.setattr(ts, "_expand_frontier", ts._expand_frontier_plain)
    pv, pi = ts.topsim_simrank(g, CELL, key=KEY, device=dev)
    np.testing.assert_array_equal(vals.view(np.int32), pv.view(np.int32))
    np.testing.assert_array_equal(idx, pi)
