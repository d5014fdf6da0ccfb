"""graphtpu_torch's edge set against graphtpu's: the probe hashes bit-equal
to the numpy forms, the host-built tables bit-equal, and the probes equal
on random, real and invalid pairs, in both modes."""

import numpy as np
import pytest
import torch

from graphtpu.core.graph import build_graph as j_build_graph
from graphtpu.kernels import edgeset as jes
from graphtpu_torch import build_graph
from graphtpu_torch.kernels import edgeset as tes

torch.set_num_threads(1)


def _graphs(v, e, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return j_build_graph(edges, n_nodes=v), build_graph(edges, n_nodes=v)


def test_mix32_and_fingerprint_bit_equal_to_numpy():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint64).astype(np.uint32)
    tu, tv = torch.from_numpy(u.astype(np.int64)), torch.from_numpy(v.astype(np.int64))
    np.testing.assert_array_equal(tes._mix32(tu).numpy(), jes._mix32_np(u).astype(np.int64))
    h, fp = tes._fingerprint(tu, tv)
    jh, jfp = jes._fingerprint_np(u, v)
    np.testing.assert_array_equal(h.numpy(), jh.astype(np.int64))
    np.testing.assert_array_equal(fp.numpy(), jfp.astype(np.int64))
    # the numpy copy kept in the port is graphtpu's
    np.testing.assert_array_equal(tes._mix32_np(u), jes._mix32_np(u))


@pytest.mark.parametrize("v,e,budget,mode", [
    (97, 400, 64 << 20, "bitmap"),
    (97, 400, 0, "cuckoo"),
    (5000, 60000, 0, "cuckoo"),
])
def test_build_edge_set_tables_bit_equal(v, e, budget, mode):
    jg, tg = _graphs(v, e, seed=3)
    js = jes.build_edge_set(jg, bitmap_byte_budget=budget)
    ts = tes.build_edge_set(tg, bitmap_byte_budget=budget)
    assert ts.mode == js.mode == mode
    assert (ts.n_nodes, ts.mask) == (js.n_nodes, js.mask)
    if mode == "bitmap":
        assert ts.words.dtype == torch.int32 and ts.table is None
        np.testing.assert_array_equal(ts.words.numpy().view(np.uint32), np.asarray(js.words))
    else:
        assert ts.table.dtype == torch.int64 and ts.words is None
        np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table).astype(np.int64))


@pytest.mark.parametrize("budget", [64 << 20, 0])
def test_edge_set_contains_matches_graphtpu(budget):
    jg, tg = _graphs(97, 400, seed=3)
    js = jes.build_edge_set(jg, bitmap_byte_budget=budget)
    ts = tes.build_edge_set(tg, bitmap_byte_budget=budget)
    rng = np.random.default_rng(4)
    us = rng.integers(-2, 97, size=4096).astype(np.int32)
    vs = rng.integers(-2, 97, size=4096).astype(np.int32)
    got = tes.edge_set_contains(ts, torch.from_numpy(us), torch.from_numpy(vs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jes.edge_set_contains(js, us, vs)))
    # every real edge is found
    rp, col, _, deg = tg.host
    src = np.repeat(np.arange(97, dtype=np.int32), deg)
    assert tes.edge_set_contains(ts, torch.from_numpy(src), torch.from_numpy(col)).all()
    true = set(zip(src.tolist(), col.tolist()))
    assert got.tolist() == [(u, v) in true for u, v in zip(us.tolist(), vs.tolist())]


@pytest.mark.parametrize("budget", [64 << 20, 0])
def test_edge_set_contains_broadcast_and_invalid(budget):
    jg, tg = _graphs(31, 90, seed=5)
    js = jes.build_edge_set(jg, bitmap_byte_budget=budget)
    ts = tes.build_edge_set(tg, bitmap_byte_budget=budget)
    u = np.array([[-1], [0], [5]], np.int32)
    v = np.array([[0, 3, -1]], np.int32)
    out = tes.edge_set_contains(ts, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert out.shape == (3, 3)
    assert not out[0].any() and not out[:, 2].any()
    np.testing.assert_array_equal(out, np.asarray(jes.edge_set_contains(js, u, v)))


def test_edge_set_caches_per_graph():
    _, tg = _graphs(97, 400, seed=7)
    _, other = _graphs(97, 400, seed=8)
    assert tes.edge_set(tg) is tes.edge_set(tg)
    assert tes.edge_set(other) is not tes.edge_set(tg)
    # a copy of the graph (same host arrays) shares its sets
    assert tes.device_edge_set(tg.to("cpu")) is tes.device_edge_set(tg)
    assert tes.device_edge_set(tg).words.device.type == "cpu"
    np.testing.assert_array_equal(tes.device_edge_set(other).words.numpy(),
                                  tes.build_edge_set(other).words.numpy())
