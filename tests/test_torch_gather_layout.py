"""The compact level plan kernel B3's column panel reads (csrc/gather.cu),
on the CPU: built from graphtpu's reduction tree, decoded back it must give
the tree's slots and weights wherever a weight is nonzero, with the right
counts, per-row weights and 16-bit slots; the plain gather over it must be
bit-equal to graphtpu's XLA level primitive and its Pallas kernel
(interpret mode), and so must a numpy model of the panel's sum, which stops
at each mini-row's count."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphtpu
import graphtpu_torch as gt
from graphtpu.kernels import spmm as jspmm
from graphtpu_torch.kernels import spmm

torch.set_num_threads(1)

V = 67


def _edges(weighted):
    """tests/test_spmm.py's graph: a hub row of degree V-2 (three levels or
    more) and an isolated last node."""
    rng = np.random.default_rng(0)
    edges = rng.integers(0, V, size=(600, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    hub = np.stack([np.zeros(V - 2, np.int64), np.arange(1, V - 1)], 1)
    edges = np.concatenate([edges, hub])
    edges = edges[(edges[:, 0] != V - 1) & (edges[:, 1] != V - 1)]
    wts = rng.random(len(edges)).astype(np.float32) + 0.1 if weighted else None
    return edges, wts


def _graphtpu_tree(width, weighted):
    edges, wts = _edges(weighted)
    jg = graphtpu.build_graph(edges, weights=wts, n_nodes=V)
    jt = jspmm.build_reduction_tree(jg, width=width, weighted=weighted)
    return [np.array(l) for l in jt.levels], [np.array(w) for w in jt.weights]


def _expand(lay):
    """Decode a GatherLayout's chunks: (slots int16 [M, W], weights f32
    [M, W] with 0 at j >= count, counts [M])."""
    w, rows = lay.width, spmm.GATHER_CHUNK_ROWS
    cb = spmm.gather_chunk_bytes(w)
    d = lay.data.numpy().reshape(lay.n_chunks, cb)

    def take(off, nbytes, dt, per_j):
        a = d[:, off:off + nbytes].copy().view(dt)
        if per_j:  # [chunk, warp, j, lane] -> [mini-row, j]
            return a.reshape(lay.n_chunks, spmm.SELL_WARPS, w, 32).transpose(0, 1, 3, 2).reshape(-1, w)
        return a.reshape(-1)

    slots = take(0, rows * 2 * w, np.int16, True)
    off = rows * 2 * w
    wts = np.repeat(take(off, rows * 4, np.float32, False)[:, None], w, 1)
    off += rows * 4
    cnt = take(off, rows, np.uint8, False).astype(np.int64)
    assert off + rows == cb
    valid = np.arange(w)[None, :] < cnt[:, None]
    m = lay.n_rows
    return slots[:m], np.where(valid, wts, np.float32(0))[:m], cnt[:m]


def _panel_model(slots, weights, cnt, table):
    """numpy model of the panel's f32 sum: acc = x0·w0, then acc + xj·wj
    for j < count, each product rounded; 0 for a count of 0."""
    acc = np.zeros((len(slots), table.shape[1]), np.float32)
    for j in range(slots.shape[1]):
        on = cnt > j
        p = table[slots[on, j].astype(np.int64)] * weights[on, j][:, None]
        acc[on] = p if j == 0 else acc[on] + p
    return acc


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_plan_holds_graphtpu_tree(width, weighted):
    levels, weights = _graphtpu_tree(width, weighted)
    assert len(levels) >= 3
    for k, (sl, wt) in enumerate(zip(levels, weights)):
        lay = spmm.build_gather_layout(sl, wt)
        if weighted and k == 0:
            assert lay is None  # a weight per slot: the row tiles run it
            continue
        assert lay is not None and lay.width == width and lay.n_rows == sl.shape[0]
        assert lay.data.dtype == torch.uint8
        assert lay.data.numel() == lay.n_chunks * spmm.gather_chunk_bytes(width)
        assert lay.n_chunks == -(-sl.shape[0] // spmm.GATHER_CHUNK_ROWS)
        got_sl, got_w, cnt = _expand(lay)
        nz = wt != 0
        # the same slot and weight bits wherever the weight is nonzero
        assert np.array_equal(got_sl[nz], sl[nz])
        assert got_w[nz].tobytes() == wt[nz].tobytes()
        assert not got_w[~nz].any()
        # count: one past the last nonzero weight; nothing stored past it
        j = np.arange(1, width + 1)
        assert np.array_equal(cnt, np.where(nz, j, 0).max(1))
        assert not got_sl[np.arange(width)[None, :] >= cnt[:, None]].any()
        assert lay.n_table == int(sl[nz].max()) + 1
        # the mini-row's one weight is each of its valid weights
        assert ((wt == wt[:, :1]) | ~(np.arange(width)[None, :] < cnt[:, None])).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_gather_over_plan_bit_equal_to_xla_and_pallas(width, weighted):
    levels, weights = _graphtpu_tree(width, weighted)
    rng = np.random.default_rng(5)
    table = rng.random((max(V, max(l.shape[0] for l in levels)), 1024)).astype(np.float32)
    pallas_done = False
    for sl, wt in zip(levels, weights):
        lay = spmm.build_gather_layout(sl, wt)
        if lay is None:  # weighted level 0
            continue
        got_sl, got_w, cnt = _expand(lay)
        plain = spmm.gather_rows_sum_plain(
            torch.from_numpy(got_sl.astype(np.int32)), torch.from_numpy(got_w),
            torch.from_numpy(table)).numpy()
        xla = np.asarray(jspmm.gather_rows_sum_xla(
            jnp.asarray(sl), jnp.asarray(wt), jnp.asarray(table)))
        assert plain.tobytes() == xla.tobytes()
        # the panel stops at each count: the trailing x·0 it skips add ±0
        model = _panel_model(got_sl, got_w, cnt, table)
        assert np.array_equal(model, xla)
        if not pallas_done:  # the first level with a plan
            pallas = np.asarray(jspmm.gather_rows_sum_pallas(
                jnp.asarray(sl), jnp.asarray(wt), jnp.asarray(table), interpret=True))
            assert plain.tobytes() == pallas.tobytes()
            pallas_done = True
    assert pallas_done


def test_plan_of_a_bf16_level_model_matches_plain():
    """bf16 tables are widened before the multiply: the model over the plan
    equals the plain version of the level."""
    levels, weights = _graphtpu_tree(8, False)
    sl, wt = torch.from_numpy(levels[0]), torch.from_numpy(weights[0])
    table = torch.from_numpy(np.random.default_rng(6).random((V, 48)).astype(np.float32))
    tb = table.bfloat16()
    got_sl, got_w, cnt = _expand(spmm.build_gather_layout(levels[0], weights[0]))
    model = _panel_model(got_sl, got_w, cnt, tb.float().numpy())
    assert np.array_equal(model, spmm.gather_rows_sum_plain(sl, wt, tb).numpy())


@pytest.mark.parametrize("n,width,want", [
    (10_240, 8, True),      # blog level 0 (largest slot 10,239 of V = 10,496)
    (10_496, 8, True),      # every row of the blog iterate
    (12_504, 8, True),      # the largest table at W = 8
    (12_505, 8, False),
    (15_475, 8, False),     # blog level 2
    (16_384, 8, False),     # R-MAT level 0: row tiles
    (13_272, 4, True),      # narrower chunks leave more room
    (13_273, 4, False),
    (100, 9, False),        # the panel takes W <= 8
])
def test_fits(n, width, want):
    assert spmm.gather_fits(n, width) == want


def test_build_refuses_levels_past_the_panel():
    sl = np.array([[0, 16_383, 0, 0]], np.int32)
    w = np.array([[1.0, 1.0, 0.0, 0.0]], np.float32)
    assert spmm.build_gather_layout(sl, w) is None  # 16,384 table rows
    assert spmm.build_gather_layout(np.tile(sl, 3), np.tile(w, 3)) is None  # W = 12
    # a trailing pad's slot is not read, so it does not size the panel
    lay = spmm.build_gather_layout(np.array([[5, 16_383]], np.int32),
                                   np.array([[2.0, 0.0]], np.float32))
    assert lay.n_table == 6
    # a weight per slot (weighted level 0): no plan, the row tiles run it
    assert spmm.build_gather_layout(np.array([[1, 2]], np.int32),
                                    np.array([[0.5, 0.25]], np.float32)) is None
    assert spmm.build_gather_layout(np.array([[1, 2, 0]], np.int32),
                                    np.array([[0.5, 0.5, 0.0]], np.float32)) is not None


def test_tree_carries_plans_only_on_the_card():
    edges, _ = _edges(False)
    g = gt.build_graph(edges, n_nodes=V)
    tree = spmm.build_reduction_tree(g)
    assert tree.layouts == () and tree.layout(0) is None and tree.layout_host_ms == 0.0
    assert tree.to("cpu").layouts == ()
    x = torch.from_numpy(np.random.default_rng(7).random((V, 40)).astype(np.float32))
    # a tree carrying plans gives the same bits on the CPU (the plain version runs)
    plans = tuple(spmm.build_gather_layout(l.numpy(), w.numpy())
                  for l, w in zip(tree.levels, tree.weights))
    carried = dataclasses.replace(tree, layouts=plans)
    assert carried.layout(0) is plans[0] and carried.layout_host_ms > 0
    assert torch.equal(spmm.tree_spmm(carried, x, 16), spmm.tree_spmm(tree, x, 16))


def test_gather_checks_the_plan_against_the_level():
    """Each level's plan covers that level, and its panel only the table
    the level reads (x for level 0, the real rows of the level before);
    a level's plan is reachable only through its tree, not through
    gather_rows_sum, so no plan can meet another level's slots."""
    edges, _ = _edges(False)
    tree = spmm.build_reduction_tree(gt.build_graph(edges, n_nodes=V))
    for k, (sl, wt) in enumerate(zip(tree.levels, tree.weights)):
        lay = spmm.build_gather_layout(sl.numpy(), wt.numpy())
        assert lay.width == tree.width and lay.n_rows == sl.shape[0]
        assert lay.n_table <= (V if k == 0 else tree.real_rows[k - 1])
        assert lay.host_ms >= 0
    sl, wt = tree.levels[0], tree.weights[0]
    x = torch.rand((V, 8), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="layout"):
        spmm.gather_rows_sum(sl, wt, x, layout=spmm.build_gather_layout(sl.numpy(), wt.numpy()))


def test_tree_spmm_checks_its_inputs():
    edges, _ = _edges(False)
    tree = spmm.build_reduction_tree(gt.build_graph(edges, n_nodes=V))
    x = torch.rand((V, 8), generator=torch.Generator().manual_seed(1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm.tree_spmm(tree, x.double())
    with pytest.raises(ValueError, match="tree on"):
        spmm.tree_spmm(tree, x.to("meta"))
    # bf16 iterates: the plain version widens before the multiply
    assert torch.equal(spmm.tree_spmm(tree, x.bfloat16()),
                       spmm.tree_spmm(tree, x.bfloat16().float()))
