"""graphtpu_torch's TopSim against the benchmark's plain references.

The estimator on given frontiers (``topsim_frontiers_topk``) against the
plain float64 estimator of ``benchmark/reference/topsim.py`` on the same
frontiers; the frontiers the tile loop makes against the reference's
spreading rule, which also sees a frontier made wrong; the timed path
(``stage_times``) against the untimed one, with the counts of
``TOPSIM_COUNTS``; the staged tile loop against the fused one it replaced,
bit for bit; and the all-sources solve against exact SimRank after STEP
iterations (``benchmark/reference/simrank.py``)."""

import numpy as np
import pytest
import torch

from benchmark.gen.graphs import urand
from benchmark.reference import simrank as exact_reference
from benchmark.reference import topsim as reference
from graphtpu_torch.core.config import TopSimConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.kernels.topk import segment_topk
from graphtpu_torch.simrank import topsim as ts
from graphtpu_torch.simrank.uniwalk import _first_meet_mask

torch.set_num_threads(1)
CPU = "cpu"
TOL = 1e-6  # of a row's scale: float32 item values, totals rounded once to float32


def _ring_edges():
    """A ring of 20 nodes with chords (degrees 2-4), and node 20 alone:
    a source at a dead end, whose frontier dies at depth 0."""
    return np.array([[i, (i + 1) % 20] for i in range(20)]
                     + [[0, 7], [3, 12], [5, 15], [9, 18], [0, 11]])


SOURCES = np.array([0, 3, 7, 20, 11, 19], np.int32)


@pytest.mark.parametrize("key", [1, 2**40 + 3])
def test_frontiers_topk_is_the_plain_estimator(key):
    edges = _ring_edges()
    g = build_graph(edges, n_nodes=21)
    cfg = TopSimConfig(sample=50.0, step=3, topk=8)
    fr, lost = ts.topsim_tile_frontiers(g, torch.from_numpy(SOURCES), key, cfg)
    assert float(lost.sum()) == 0.0
    even = fr[2::2]
    (p2, m2), (p4, m4) = even[0], even[1]
    src = torch.from_numpy(SOURCES)[:, None]
    assert ((m2 > 0) & (p2[:, :, 2] == src)).any() and ((m4 > 0) & (p4[:, :, 4] == src)).any()
    assert not (fr[1][1][3] > 0).any()  # node 20: no child
    vals, idx = ts.topsim_frontiers_topk(g, even, cfg)
    _, deg = reference.adjacency(edges, 21)
    dense = reference.scores(even, deg, 21, cfg.c, cfg.sample).numpy()
    vals, idx = vals.numpy(), idx.numpy()
    assert (dense[np.arange(len(SOURCES)), SOURCES] == 0).all()
    assert (dense[3] == 0).all() and (idx[3] == -1).all() and (vals[3] == 0).all()
    top = -np.sort(-dense, axis=1)[:, :cfg.topk]
    scale = np.maximum(top[:, 0], np.median(top[:, 0]))
    for r in range(len(SOURCES)):
        n_pos = int((dense[r] > 0).sum())
        live = idx[r] >= 0
        assert live.sum() == min(cfg.topk, n_pos), r  # -1 pads only past the row's targets
        ids = idx[r][live]
        assert len(set(ids.tolist())) == len(ids) and (ids != SOURCES[r]).all()
        at = dense[r, ids]
        assert np.abs(vals[r][live] - at).max(initial=0) <= TOL * scale[r], r
        assert (top[r, :len(ids)] - at).max(initial=0) <= TOL * scale[r], r


def test_frontiers_topk_wants_the_configurations_depths():
    g = build_graph(_ring_edges(), n_nodes=21)
    cfg = TopSimConfig(sample=20.0, step=2, topk=4)
    fr, _ = ts.topsim_tile_frontiers(g, torch.from_numpy(SOURCES), 3, cfg)
    with pytest.raises(ValueError, match="step 3"):
        ts.topsim_frontiers_topk(g, fr[2::2], TopSimConfig(sample=20.0, step=3, topk=4))


def _split_parent(fr, edges):
    """(depth, row, the child slots) of a live parent that splits, s > d."""
    _, deg = reference.adjacency(edges, 21)
    for d in range(len(fr) - 1):
        (pp, pm), (cp, cm) = fr[d], fr[d + 1]
        for r, w in zip(*np.nonzero(pm.numpy() > 0)):
            u = int(pp[r, w, d])
            if float(pm[r, w]) > deg[u] > 0:
                prefix = pp[r, w, : d + 1]
                kids = ((cm[r] > 0) & (cp[r, :, : d + 1] == prefix).all(dim=1)).nonzero()[:, 0]
                if len(kids) == deg[u]:  # no other parent of this path
                    return d, r, kids
    raise AssertionError("no split parent")


def _moved(fr, edges):
    """One child moved to a node that is not its parent's neighbour."""
    paths, mass = fr[2]
    r, w = (mass > 0).nonzero()[0].tolist()
    keys, _ = reference.adjacency(edges, 21)
    u = int(paths[r, w, 1])
    x = next(x for x in range(21) if u * 21 + x not in set(keys.tolist()) and x != u)
    paths = paths.clone()
    paths[r, w, 2] = x
    return {2: (paths, mass)}


def _mass_changed(fr, edges):
    paths, mass = fr[3]
    r, w = (mass > 0).nonzero()[0].tolist()
    mass = mass.clone()
    mass[r, w] *= 1.0 + 1e-4
    return {3: (paths, mass)}


def _split_sampled(fr, edges):
    """A split parent's children all drawn at its first neighbour, as a
    sample of its degree's size could draw them."""
    d, r, kids = _split_parent(fr, edges)
    paths = fr[d + 1][0].clone()
    paths[r, kids, d + 1] = paths[r, kids[0], d + 1]
    return {d + 1: (paths, fr[d + 1][1])}


@pytest.mark.parametrize("fault,bad", [(None, False), (_moved, True), (_mass_changed, True),
                                       (_split_sampled, True)])
def test_rule_check_reads_the_program_frontiers(fault, bad):
    edges = _ring_edges()
    g = build_graph(edges, n_nodes=21)
    cfg = TopSimConfig(sample=50.0, step=3, topk=8)
    fr, _ = ts.topsim_tile_frontiers(g, torch.from_numpy(SOURCES), 7, cfg)
    if fault is not None:
        fr = [fault(fr, edges).get(d, f) for d, f in enumerate(fr)]
    assert (reference.spread_bad(fr, edges, 21, cfg.sample) > 0) == bad


def test_rule_check_sees_a_cut_frontier():
    """W below what the spreading needs: children find no slot."""
    edges = urand(3, 7, 8)
    g = build_graph(edges, n_nodes=128)
    cfg = TopSimConfig(sample=200.0, step=2, topk=8, frontier_capacity=200)
    fr, lost = ts.topsim_tile_frontiers(g, torch.arange(8, dtype=torch.int32), 4, cfg)
    assert float(lost.sum()) > 0
    assert reference.spread_bad(fr, edges, 128, cfg.sample) > 0
    full, _ = ts.topsim_tile_frontiers(g, torch.arange(8, dtype=torch.int32), 4,
                                       TopSimConfig(sample=200.0, step=2, topk=8))
    assert reference.spread_bad(full, edges, 128, cfg.sample) == 0


def _live(g, sources, tile, key, cfg):
    """The live slots of every tile's frontiers at depths 1..2*step."""
    padded = np.zeros(-(-len(sources) // tile) * tile, np.int32)
    padded[:len(sources)] = sources
    n = 0
    for lo in range(0, len(sources), tile):
        fr, _ = ts.topsim_tile_frontiers(g, torch.from_numpy(padded[lo:lo + tile]),
                                         key_for(key, lo), cfg)
        n += sum(int((m > 0).sum()) for _, m in fr[1:])
    return n


@pytest.mark.parametrize("n_nodes", [64, 65])
def test_stage_times_leave_the_answers_and_count_the_work(n_nodes):
    """V = 64: four full tiles.  V = 65: node 64 has no neighbour, and the
    last tile's 15 pad sources (source 0) are spread."""
    g = build_graph(urand(4, 6, 8), n_nodes=n_nodes)
    cfg = TopSimConfig(sample=40.0, step=2, topk=10, source_tile=16)
    before = dict(ts.TOPSIM_COUNTS)
    plain = ts.topsim_simrank(g, cfg, key=9, device=CPU)
    untimed = {k: ts.TOPSIM_COUNTS[k] - n for k, n in before.items()}
    times = {}
    before = dict(ts.TOPSIM_COUNTS)
    timed = ts.topsim_simrank(g, cfg, key=9, device=CPU, stage_times=times)
    counts = {k: ts.TOPSIM_COUNTS[k] - n for k, n in before.items()}
    for a, b in zip(plain, timed):
        np.testing.assert_array_equal(a, b)
    assert set(times) == {"expand", "items", "reduce"}
    assert min(times.values()) >= 0
    spread = -(-n_nodes // 16) * 16
    live = _live(g, np.arange(n_nodes, dtype=np.int32), 16, 9, cfg)
    assert 0 < live < spread * 88 * 4
    assert counts == {"sources": spread, "slots": spread * 88 * 4, "live": live}
    assert untimed == counts


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
        paths, mass, _ = ts._expand_frontier(g, paths, mass, depth, key_for(key, depth),
                                             enumerate_all=cfg.enumerate_all)
        i = (depth + 1) // 2
        if depth % 2 == 0:
            continue
        inter, target = paths[:, :, i], paths[:, :, 2 * i]
        ok = ((mass > 0) & (target >= 0) & (target != src_tile[:, None])
              & _first_meet_mask(paths[:, :, : 2 * i + 1], i))
        val = (mass * (cfg.c ** i) * g.deg[inter.clamp(min=0)].float()
               / g.deg[target.clamp(min=0)].clamp(min=1).float())
        if cfg.normalize:
            val = val / cfg.sample
        tgt_list.append(torch.where(ok, target, -1))
        val_list.append(torch.where(ok, val, 0.0))
    return torch.cat(tgt_list, dim=1), torch.cat(val_list, dim=1)


@pytest.mark.parametrize("cfg", [
    TopSimConfig(sample=60.0, step=3, topk=6, source_tile=8),
    TopSimConfig(sample=7.5, step=2, topk=5, source_tile=8, normalize=False),
    TopSimConfig(sample=10.0, step=1, topk=6, source_tile=8, enumerate_all=True),
], ids=["sample", "raw-mass", "enumerate"])
def test_staged_solve_is_the_fused_tile_loop(cfg):
    """The same key: every tile's rows are the fused loop's items reduced,
    bit for bit (the stages reorder no draw; the tiles, here all in one
    group, draw each on its own streams)."""
    g = build_graph(urand(6, 6, 8), n_nodes=64)
    sources = np.arange(1, 64, 3, dtype=np.int32)  # 21 sources: tiles of 8, 8, 5
    cap = ts.frontier_capacity(g, cfg)
    vals, idx = ts.topsim_simrank(g, cfg, key=2**33 + 5, sources=sources, device=CPU)
    for lo in range(0, len(sources), 8):
        chunk = np.zeros(8, np.int32)
        m = len(sources[lo:lo + 8])
        chunk[:m] = sources[lo:lo + 8]
        t, v = _fused_tile_items(g, torch.from_numpy(chunk), key_for(2**33 + 5, lo), cfg, cap)
        tv, ti = segment_topk(t, v, cfg.topk, 64)
        np.testing.assert_array_equal(vals[lo:lo + m], tv[:m].numpy())
        np.testing.assert_array_equal(idx[lo:lo + m], ti[:m].numpy())


@pytest.fixture(scope="module")
def urand128():
    edges = urand(3, 7, 8)
    s = exact_reference.simrank(edges, 128, 0.6, 3, CPU)
    return build_graph(edges, n_nodes=128), torch.topk(s, 20, dim=1)


# On this graph, keys 11-13, the published SAMPLE (10,000) reads a mean
# precision@20 of 0.936-0.940 against exact SimRank after STEP = 3
# iterations, a quarter of it 0.878-0.881 (seed 4's graph: 0.944-0.946
# against 0.878-0.887): the threshold lies between, so a solve that spreads
# less than it is told falls below it.
PRECISION_AT_SAMPLE = 0.91


@pytest.mark.parametrize("sample,above", [(10_000.0, True), (2_500.0, False)])
def test_all_sources_against_exact_simrank(urand128, sample, above):
    g, gold = urand128
    assert (gold.values[:, 0] > 0).all()
    stats = {}
    vals, idx = ts.topsim_simrank(g, TopSimConfig(sample=sample, step=3, topk=20), key=11,
                                  device=CPU, stats=stats)
    assert (idx >= 0).all() and stats["dropped_mass"] == 0.0
    ids = torch.as_tensor(idx).long()
    hits = (ids[:, :, None] == gold.indices[:, None, :]).any(dim=2).sum(dim=1)
    assert (float(hits.double().mean()) / 20 > PRECISION_AT_SAMPLE) == above
