"""TopSim's frontier expansion (``simrank/topsim.py:_expand_frontier``) on
the CPU: a CPU tensor takes the plain version and launches nothing; the
checks that TS1's wrapper makes before any launch; the draws a block of
rows takes from its own key; and a numpy model of TS1's algorithm (the
parents a chunk at a time, their first slots clamped to W, each child's
parent found by a binary search of its chunk's first slots, the draw's row
length read from ``row_ptr``) held to the plain version bit for bit, so
that the kernel's design is tested where it cannot run.  The kernel itself is held to the plain version on the card in
``tests/test_torch_expand_cuda.py``."""

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

torch.set_num_threads(1)

# the plain version's float32 row sum and the model's numpy one add the
# dropped masses in other orders: a few float32 roundings of the row's total
DROP_RTOL = 1e-5


def _ring():
    """A ring of 20 nodes with chords (degrees 2-4), and node 20 alone."""
    edges = np.array([[i, (i + 1) % 20] for i in range(20)]
                     + [[0, 7], [3, 12], [5, 15], [9, 18], [0, 11]])
    return build_graph(edges, n_nodes=21)


def _start(src, cap, length, sample):
    paths = torch.full((len(src), cap, length), -1, dtype=torch.int32)
    paths[:, 0, 0] = torch.as_tensor(src, dtype=torch.int32)
    mass = torch.zeros((len(src), cap), dtype=torch.float32)
    mass[:, 0] = sample
    return paths, mass


def _ts1_model(g, paths, mass, depth, u, enumerate_all, chunk=8):
    """TS1's algorithm in numpy, a row at a time, as ``csrc/expand.cu``
    writes it (``chunk`` parents at a time where the kernel takes 1,024):
    (paths', mass', dropped)."""
    rp, col, deg = g.row_ptr.numpy().astype(np.int64), g.col.numpy(), g.deg.numpy()
    p_in, m_in = paths.numpy(), mass.numpy()
    t, w, length = p_in.shape
    uu = None if u is None else u.numpy().reshape(t, w)
    out_p = np.full_like(p_in, -1)
    out_m = np.zeros_like(m_in)
    dropped = np.zeros(t, np.float32)
    last_edge = max(len(col) - 1, 0)
    for r in range(t):
        carry, written, drop = 0, 0, []
        for base in range(0, w, chunk):
            # A. the chunk's counts and first slots (the node read where mass > 0)
            m = np.zeros(chunk, np.float32)
            m[:min(chunk, w - base)] = m_in[r, base:base + chunk]
            cur = np.full(chunk, -1, np.int64)
            live = np.flatnonzero(m > 0)
            cur[live] = p_in[r, base + live, depth]
            d = np.where(cur >= 0, deg[np.maximum(cur, 0)], 0)
            active = (m > 0) & (cur >= 0) & (d > 0)
            split = active & (enumerate_all | (m >= d.astype(np.float32)))
            nc = np.where(active, np.where(split, d, np.ceil(m).astype(np.int64)), 0)
            first = carry + np.cumsum(nc) - nc
            offs = np.minimum(first, w)  # int32 in the kernel: clamped to W
            lost = np.minimum(np.maximum(first + nc - w, 0), nc)
            drop.append(m * lost.astype(np.float32) / np.maximum(nc, 1).astype(np.float32))
            carry += int(nc.sum())
            # B. the slots whose parents are in the chunk
            end = min(carry, w)
            s = np.arange(written, end)
            lo, hi = np.zeros(len(s), np.int64), np.full(len(s), chunk - 1)
            while (lo < hi).any():  # the last parent whose first slot is <= s
                mid = (lo + hi + 1) // 2
                go = offs[mid] <= s
                lo, hi = np.where(lo < hi, np.where(go, mid, lo), lo), \
                    np.where(lo < hi, np.where(go, hi, mid - 1), hi)
            par = lo
            pc = cur[par]
            beg = rp[pc]
            split_node = col[np.clip(beg + s - offs[par], 0, last_edge)]
            n = rp[pc + 1] - beg
            samp_node = np.full(len(s), -1, np.int32)
            if uu is not None:
                at = (uu[r, s] * n.astype(np.float32)).astype(np.int64)
                ok = n > 0
                samp_node[ok] = col[(beg + np.minimum(at, n - 1))[ok]]
            out_p[r, s] = p_in[r, base + par]
            out_p[r, s, depth + 1] = np.where(split[par], split_node, samp_node)
            out_m[r, s] = m[par] / nc[par].astype(np.float32)
            written = end
        dropped[r] = np.sum(np.concatenate(drop), dtype=np.float32)
    return out_p, out_m, dropped


def _spread_against_model(g, src, cap, step, sample, key, enumerate_all=False):
    """Spread with the plain version, holding each depth's output to the
    model on the same input; returns the total dropped mass."""
    paths, mass = _start(src, cap, 2 * step + 1, sample)
    lost = 0.0
    for depth in range(2 * step):
        dkey = [key_for(key, lo, depth) for lo in range(0, len(src), 2)]
        u = None if enumerate_all else ts._draws(len(src), cap, dkey, "cpu")
        want_p, want_m, want_d = ts._expand_frontier(g, paths, mass, depth, dkey, enumerate_all)
        got_p, got_m, got_d = _ts1_model(g, paths, mass, depth, u, enumerate_all)
        np.testing.assert_array_equal(got_p, want_p.numpy())
        np.testing.assert_array_equal(got_m.view(np.int32), want_m.numpy().view(np.int32))
        np.testing.assert_allclose(got_d, want_d.numpy(), rtol=DROP_RTOL, atol=0)
        paths, mass = want_p, want_m
        lost += float(want_d.sum())
    return lost


@pytest.mark.parametrize("case", ["urand", "w-cut", "kron-isolated", "enumerate"])
def test_ts1_model_is_the_plain_version(case):
    """TS1's algorithm gives the plain version's slots and masses, bit for
    bit, at every depth: no overflow, overflow (W cut to SAMPLE), isolated
    nodes and every parent splitting."""
    if case == "enumerate":
        g = _ring()
        lost = _spread_against_model(g, [0, 3, 20, 11], 300, 2, 1.0, 7, enumerate_all=True)
        assert lost == 0.0
        return
    if case == "kron-isolated":
        g = build_graph(kron(3, 8, 4, (0.57, 0.19, 0.19, 0.05)), n_nodes=256)
        assert (g.deg == 0).any()
        src = np.flatnonzero(g.deg.numpy() == 0)[:2].tolist() + [0, 1, 2, 3]
    else:
        g = build_graph(urand(5, 8, 8), n_nodes=256)
        src = list(range(40, 46))
    sample = 60.0
    cap = int(sample) if case == "w-cut" else 2 * int(sample) + 8
    lost = _spread_against_model(g, src, cap, 3, sample, 2**41 + 9)
    assert (lost > 0) == (case == "w-cut")


def test_ts1_model_under_the_sampled_control():
    """``readings_topsim.sampled()``: every degree raised for the split rule,
    the draws from the graph's own rows.  The plain version under the
    control is TS1's rule given the raised degrees, which draws from
    ``row_ptr``."""
    g = build_graph(urand(6, 8, 8), n_nodes=256)
    raised = dataclasses.replace(g, deg=g.deg + (1 << 30))
    paths, mass = _start([5, 9], 128, 5, 50.0)
    with readings_topsim.sampled():
        for depth in range(4):
            want_p, want_m, _ = ts._expand_frontier(g, paths, mass, depth, depth)
            u = ts._draws(2, 128, depth, "cpu")
            got_p, got_m, _ = _ts1_model(raised, paths, mass, depth, u, False)
            np.testing.assert_array_equal(got_p, want_p.numpy())
            np.testing.assert_array_equal(got_m.view(np.int32), want_m.numpy().view(np.int32))
            paths, mass = want_p, want_m
    assert (mass > 0).any()


@pytest.mark.parametrize("enumerate_all", [False, True])
@pytest.mark.parametrize("key", [3, [3, 2**40 + 1]])
def test_cpu_takes_the_plain_path(key, enumerate_all):
    g = _ring()
    paths, mass = _start([0, 3, 20, 11], 120, 5, 40.0)
    before = dict(ts.EXPAND_LAUNCHES)
    for depth in range(4):
        got = ts._expand_frontier(g, paths, mass, depth, key, enumerate_all)
        want = ts._expand_frontier_plain(g, paths, mass, depth, key, enumerate_all)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        paths, mass = got[0], got[1]
    assert ts.EXPAND_LAUNCHES == before


def test_cpu_solve_launches_nothing():
    before = dict(ts.EXPAND_LAUNCHES)
    ts.topsim_simrank(_ring(), TopSimConfig(sample=20.0, step=2, topk=4, source_tile=8),
                      key=5, device="cpu")
    assert ts.EXPAND_LAUNCHES == before


def test_draws_give_each_block_its_key():
    u = ts._draws(4, 10, [11, 12], "cpu")
    alone = ts._draws(2, 10, 12, "cpu")
    assert u.shape == (40,) and u.dtype == torch.float32
    assert torch.equal(u[20:], alone) and not torch.equal(u[:20], alone)
    assert ((u >= 0) & (u < 1)).all()


def _args(case):
    g = _ring()
    paths, mass = _start([0, 3], 16, 5, 10.0)
    depth = 1
    if case == "paths-int64":
        paths = paths.long()
    elif case == "paths-2d":
        paths = paths[:, :, 0]
    elif case == "mass-float64":
        mass = mass.double()
    elif case == "mass-shape":
        mass = mass[:, :8]
    elif case == "paths-non-contiguous":
        paths = paths.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mass-non-contiguous":
        mass = mass.t().contiguous().t()
    elif case == "depth-last":
        depth = 4
    elif case == "depth-negative":
        depth = -1
    elif case == "no-slots":
        paths, mass = paths[:, :0], mass[:, :0]
    elif case == "row-ptr-float":
        g = dataclasses.replace(g, row_ptr=g.row_ptr.float())
    elif case == "col-int64":
        g = dataclasses.replace(g, col=g.col.long())
    elif case == "deg-int64":
        g = dataclasses.replace(g, deg=g.deg.long())
    elif case == "deg-non-contiguous":
        g = dataclasses.replace(g, deg=torch.stack([g.deg, g.deg], 1)[:, 0])
    elif case == "mass-other-device":
        mass = mass.to("meta")
    elif case == "graph-other-device":
        g = dataclasses.replace(g, col=g.col.to("meta"))
    elif case == "row-ptr-int64":
        g = dataclasses.replace(g, row_ptr=g.row_ptr.long())
    elif case == "depth-first":
        depth = 0
    return g, paths, mass, depth


@pytest.mark.parametrize("case,err,says", [
    ("paths-int64", TypeError, "int32 paths"),
    ("paths-2d", TypeError, "int32 paths"),
    ("mass-float64", TypeError, "float32 mass"),
    ("mass-shape", TypeError, "float32 mass"),
    ("paths-non-contiguous", ValueError, "paths is not"),
    ("mass-non-contiguous", ValueError, "mass is not"),
    ("depth-last", ValueError, "leaves paths"),
    ("depth-negative", ValueError, "leaves paths"),
    ("no-slots", ValueError, "slots a row"),
    ("row-ptr-float", TypeError, "row_ptr"),
    ("col-int64", TypeError, "col"),
    ("deg-int64", TypeError, "deg"),
    ("deg-non-contiguous", ValueError, "deg is not"),
    ("mass-other-device", ValueError, "one device"),
    ("graph-other-device", ValueError, "one device"),
])
def test_kernel_args_rejected_before_any_launch(case, err, says):
    g, paths, mass, depth = _args(case)
    before = dict(ts.EXPAND_LAUNCHES)
    with pytest.raises(err, match=says):
        ts.check_expand_args(g, paths, mass, depth)
    assert ts.EXPAND_LAUNCHES == before


@pytest.mark.parametrize("u", ["none", "float64", "short", "2-slot-stride"])
def test_draws_rejected_before_any_launch(u):
    """``ts1_expand`` takes [T * W] contiguous float32 draws, or none only
    where every parent splits."""
    g, paths, mass, depth = _args("depth-1")
    n = paths.shape[0] * paths.shape[1]
    u = {"none": None, "float64": torch.zeros(n, dtype=torch.float64),
         "short": torch.zeros(n - 1), "2-slot-stride": torch.zeros(2 * n)[::2]}[u]
    before = dict(ts.EXPAND_LAUNCHES)
    with pytest.raises(ValueError, match="u"):
        ts.ts1_expand(g, paths, mass, depth, u)
    assert ts.EXPAND_LAUNCHES == before


@pytest.mark.parametrize("case", ["row-ptr-int64", "depth-first", "depth-1"])
def test_kernel_args_accepted(case):
    ts.check_expand_args(*_args(case))


def test_other_devices_raise():
    g = _ring()
    paths, mass = _start([0], 8, 3, 4.0)
    with pytest.raises(RuntimeError, match="no expansion kernel"):
        ts._expand_frontier(g, paths.to("meta"), mass.to("meta"), 0, 1)
