"""graphtpu_torch's TopSim on an NVIDIA GPU against the benchmark's plain
reference (``benchmark/reference/topsim.py``): one tile of the card's own
solve, its frontiers made anew on the card from the solve's key, holds to
the spreading rule and to the plain float64 estimator; the solve's tiles,
run side by side in groups, are the per-tile loop's bit for bit; seeded
solves are bit-equal, timed or not.  The card's draws are not the CPU's, so the card
is not compared with the CPU.  Every test needs a card and skips without
one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_topsim_cuda.py
"""

import numpy as np
import pytest
import torch

from benchmark.gen.graphs import urand
from benchmark.reference import topsim as reference
from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.kernels.topk import segment_topk
from graphtpu_torch.simrank import topsim as ts
from graphtpu_torch.simrank.uniwalk import _first_meet_mask

pytestmark = pytest.mark.cuda

TOL = 1e-6  # of a row's scale: float32 item values, totals rounded once to float32
V = 1024
KEY = 2**45 + 17
CFG = TopSimConfig(sample=10_000.0, step=3, topk=20)  # the cell's SAMPLE, W and tile


@pytest.fixture(scope="module")
def solved():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    edges = urand(5, 10, 16)
    g = build_graph(edges, n_nodes=V, device=dev)
    stats = {}
    vals, idx = ts.topsim_simrank(g, CFG, key=KEY, device=dev, stats=stats)
    lo = 7 * CFG.source_tile
    src = torch.arange(lo, lo + CFG.source_tile, dtype=torch.int32, device=dev)
    frontiers, lost = ts.topsim_tile_frontiers(g, src, key_for(KEY, lo), CFG)
    return dict(edges=edges, g=g, vals=vals, idx=idx, lo=lo, frontiers=frontiers, lost=lost,
                stats=stats, dev=dev)


def test_card_frontiers_keep_the_spreading_rule(solved):
    assert solved["frontiers"][0][0].device.type == "cuda"
    assert reference.spread_bad(solved["frontiers"], solved["edges"], V, CFG.sample) == 0
    assert float(solved["lost"].sum()) == 0.0 and solved["stats"]["dropped_mass"] == 0.0


def test_card_solve_is_the_plain_estimator_on_its_frontiers(solved):
    lo, t = solved["lo"], CFG.source_tile
    even = solved["frontiers"][2::2]
    vals, idx = solved["vals"][lo:lo + t], solved["idx"][lo:lo + t]
    tv, ti = ts.topsim_frontiers_topk(solved["g"], even, CFG)
    np.testing.assert_array_equal(vals, tv.cpu().numpy())
    np.testing.assert_array_equal(idx, ti.cpu().numpy())
    _, deg = reference.adjacency(solved["edges"], V)
    dense = reference.scores(even, deg, V, CFG.c, CFG.sample).cpu().numpy()
    top = -np.sort(-dense, axis=1)[:, :CFG.topk]
    scale = np.maximum(top[:, 0], np.median(top[:, 0]))[:, None]
    assert (idx >= 0).all() and (idx != np.arange(lo, lo + t)[:, None]).all()
    at = np.take_along_axis(dense, idx.astype(np.int64), axis=1)
    assert (np.abs(vals - at) / scale).max() <= TOL
    assert ((top - at) / scale).max() <= TOL


def test_card_solves_with_one_key_bit_equal(solved):
    times = {}
    before = dict(ts.TOPSIM_COUNTS)
    vals, idx = ts.topsim_simrank(solved["g"], CFG, key=KEY, device=solved["dev"],
                                  stage_times=times)
    counts = {k: ts.TOPSIM_COUNTS[k] - n for k, n in before.items()}
    np.testing.assert_array_equal(vals, solved["vals"])
    np.testing.assert_array_equal(idx, solved["idx"])
    assert set(times) == {"expand", "items", "reduce"} and min(times.values()) > 0
    assert counts["sources"] == V and counts["slots"] == V * 20_008 * 6
    assert 0 < counts["live"] < counts["slots"]


def _fused_tile_items(g, src_tile, key, cfg, cap):
    """The tile loop before its stages, a tile at a time: each depth's
    expansion, the items taken at each even depth as it is reached."""
    tile, dev = src_tile.shape[0], src_tile.device
    paths = torch.full((tile, cap, 2 * cfg.step + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0, 0] = src_tile
    mass = torch.zeros((tile, cap), dtype=torch.float32, device=dev)
    mass[:, 0] = cfg.sample
    tgt_list, val_list = [], []
    for depth in range(2 * cfg.step):
        paths, mass, _ = ts._expand_frontier(g, paths, mass, depth, key_for(key, depth))
        i = (depth + 1) // 2
        if depth % 2 == 0:
            continue
        inter, target = paths[:, :, i], paths[:, :, 2 * i]
        ok = ((mass > 0) & (target >= 0) & (target != src_tile[:, None])
              & _first_meet_mask(paths[:, :, : 2 * i + 1], i))
        val = (mass * (cfg.c ** i) * g.deg[inter.clamp(min=0)].float()
               / g.deg[target.clamp(min=0)].clamp(min=1).float()) / cfg.sample
        tgt_list.append(torch.where(ok, target, -1))
        val_list.append(torch.where(ok, val, 0.0))
    return torch.cat(tgt_list, dim=1), torch.cat(val_list, dim=1)


@pytest.mark.parametrize("lo", [0, 7 * 32, V - 32])
def test_card_groups_are_the_fused_tile_loop(solved, lo):
    """Several tiles a launch (``GROUP_SLOTS``), each on its own streams and
    reduced alone: a tile's rows are those of the tile run by itself."""
    g = solved["g"]
    assert 1 < ts.GROUP_SLOTS // (CFG.source_tile * 20_008) < V // CFG.source_tile
    src = torch.arange(lo, lo + CFG.source_tile, dtype=torch.int32, device=solved["dev"])
    t, v = _fused_tile_items(g, src, key_for(KEY, lo), CFG, ts.frontier_capacity(g, CFG))
    tv, ti = segment_topk(t, v, CFG.topk, V)
    np.testing.assert_array_equal(solved["vals"][lo:lo + CFG.source_tile], tv.cpu().numpy())
    np.testing.assert_array_equal(solved["idx"][lo:lo + CFG.source_tile], ti.cpu().numpy())
