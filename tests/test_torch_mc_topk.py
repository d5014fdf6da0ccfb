"""graphtpu_torch's scatter-free accumulators against graphtpu's and a
float64 oracle.

graphtpu takes each run's total as a difference of one float32 prefix sum
over a whole row (for ``pair_topk_by_source``, the whole flat stream), so
its totals carry rounding at the scale of the row's mass; the port
differences a float64 prefix and rounds each total once.  So the port is
held to the float64 oracle at 1e-6 relative, and to graphtpu within 4
float32 ulps of the row's mass.  Where two true totals
are closer than the tolerance the two packages may order them
differently, so ids are compared through their true totals: each id the
port puts at a position has a true total within the tolerance of the one
the reference puts there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.core.graph import column_normalized as j_column_normalized
from graphtpu.kernels import topk as jtk
from graphtpu_torch.core.graph import column_normalized
from graphtpu_torch.kernels import topk as ttk

torch.set_num_threads(1)
REL = 1e-6        # port vs the float64 oracle, relative to each total
ULPS = 4          # port vs graphtpu, float32 ulps of the row's mass
F32_EPS = float(np.finfo(np.float32).eps)


def _items(seed, t, n, n_classes, quantised):
    """[T, N] items with -1 skips; ``quantised`` values are multiples of
    1/4, so many sums tie exactly."""
    rng = np.random.default_rng(seed)
    tg = rng.integers(-1, n_classes, size=(t, n)).astype(np.int32)
    if quantised:
        v = (rng.integers(1, 5, size=(t, n)) / 4).astype(np.float32)
    else:
        v = rng.random((t, n)).astype(np.float32)
    return tg, v


def _oracle_rows(tg, v, n_classes):
    """float64 [T, n_classes] per-target sums."""
    out = np.zeros((tg.shape[0], n_classes))
    for r in range(tg.shape[0]):
        keep = tg[r] >= 0
        np.add.at(out[r], tg[r][keep], v[r][keep].astype(np.float64))
    return out


def _assert_ranking(vals, idx, truth, tol_row, ref_vals, ref_idx):
    """vals within tol of ref_vals; at each position the two ids' true
    totals within tol (equal ids where no near-tie)."""
    for r in range(vals.shape[0]):
        tol = tol_row[r]
        np.testing.assert_allclose(vals[r], ref_vals[r], rtol=0, atol=tol)
        for a, b in zip(idx[r], ref_idx[r]):
            if a == b:
                continue
            assert a >= 0 and b >= 0, (r, a, b)
            assert abs(truth[r, a] - truth[r, b]) <= tol, (r, a, b)


def _oracle_topk(sums, k):
    """Descending top-k of positive entries, ties by lower id; -1/0 pad."""
    t = sums.shape[0]
    vals = np.zeros((t, k))
    idx = np.full((t, k), -1)
    for r in range(t):
        nz = np.flatnonzero(sums[r] != 0)
        order = nz[np.lexsort((nz, -sums[r][nz]))][:k]
        vals[r, : len(order)] = sums[r][order]
        idx[r, : len(order)] = order
    return vals, idx


@pytest.mark.parametrize("quantised", [True, False])
@pytest.mark.parametrize("k", [5, 40])
def test_segment_topk_matches(quantised, k):
    n_classes = 30
    tg, v = _items(0, 6, 300, n_classes, quantised)
    got_v, got_i = ttk.segment_topk(torch.from_numpy(tg), torch.from_numpy(v), k, n_classes)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.dtype == np.float32 and got_i.dtype == np.int32
    sums = _oracle_rows(tg, v, n_classes)
    ov, oi = _oracle_topk(sums, k)
    mass = np.abs(v * (tg >= 0)).sum(axis=1)
    # the oracle: 1e-6 of each total; exact order where totals tie exactly
    _assert_ranking(got_v, got_i, sums, REL * np.abs(ov).max(axis=1), ov, oi)
    if quantised:
        np.testing.assert_array_equal(got_i, oi)
    jv, ji = jtk.segment_topk(jnp.asarray(tg), jnp.asarray(v), k, n_classes)
    _assert_ranking(got_v, got_i, sums, ULPS * F32_EPS * mass, np.asarray(jv), np.asarray(ji))


def test_segment_topk_empty_rows_and_k_past_n():
    tg = np.array([[-1, -1, -1], [2, 2, 1]], np.int32)
    v = np.array([[1, 2, 3], [0.5, 0.25, 1]], np.float32)
    got_v, got_i = ttk.segment_topk(torch.from_numpy(tg), torch.from_numpy(v), 5, 4)
    jv, ji = jtk.segment_topk(jnp.asarray(tg), jnp.asarray(v), 5, 4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_i.numpy(), [[-1] * 5, [1, 2, -1, -1, -1]])


def test_segment_sum_1d_matches():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 50, size=2000).astype(np.int32)
    vals = rng.random(2000).astype(np.float32)
    got = ttk.segment_sum_1d(torch.from_numpy(ids), torch.from_numpy(vals), 55).numpy()
    want = np.zeros(55)
    np.add.at(want, ids[ids >= 0], vals[ids >= 0].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert (got[50:] == 0).all()
    j = np.asarray(jtk.segment_sum_1d(jnp.asarray(ids), jnp.asarray(vals), 55))
    np.testing.assert_allclose(got, j, rtol=0, atol=ULPS * F32_EPS * vals[ids >= 0].sum())


def _pair_oracle(srcs, tgts, vals, n_src, n_tgt, counts=None):
    sums = np.zeros((n_src, n_tgt))
    keep = (srcs >= 0) & (tgts >= 0)
    np.add.at(sums, (srcs[keep], tgts[keep]), vals[keep].astype(np.float64))
    if counts is not None:
        sums = sums / np.maximum(counts[:n_src].astype(np.float64), 1.0)[:, None]
    return sums


@pytest.mark.parametrize("quantised", [True, False])
@pytest.mark.parametrize("normalise", [False, True])
def test_pair_topk_by_source_matches(quantised, normalise):
    rng = np.random.default_rng(2)
    n, n_src, n_tgt, k = 3000, 14, 40, 8
    srcs = rng.integers(-1, 12, size=n).astype(np.int32)  # sources 12, 13: no items
    tgts = rng.integers(-1, n_tgt, size=n).astype(np.int32)
    vals = ((rng.integers(1, 5, size=n) / 4) if quantised else rng.random(n)).astype(np.float32)
    counts = rng.integers(0, 6, size=n_src).astype(np.float32) if normalise else None
    source_ids = np.array([0, 1, 3, 5, 8, 11, 12, 13], np.int32)
    got_v, got_i = ttk.pair_topk_by_source(
        torch.from_numpy(srcs), torch.from_numpy(tgts), torch.from_numpy(vals),
        torch.from_numpy(source_ids), k,
        counts=None if counts is None else torch.from_numpy(counts))
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.dtype == np.float32 and got_i.dtype == np.int32
    sums = _pair_oracle(srcs, tgts, vals, n_src, n_tgt, counts)[source_ids]
    ov, oi = _oracle_topk(sums, k)
    _assert_ranking(got_v, got_i, sums, REL * np.abs(ov).max(axis=1).clip(min=1e-30), ov, oi)
    if quantised and not normalise:
        np.testing.assert_array_equal(got_i, oi)
    assert (got_i[-2:] == -1).all() and (got_v[-2:] == 0).all()
    jv, ji = jtk.pair_topk_by_source(
        jnp.asarray(srcs), jnp.asarray(tgts), jnp.asarray(vals), jnp.asarray(source_ids), k,
        counts=None if counts is None else jnp.asarray(counts))
    # graphtpu's prefix runs over the whole flat stream: its rounding is at
    # the scale of the stream's mass (over each source's count)
    mass = np.full(len(source_ids), vals[(srcs >= 0) & (tgts >= 0)].sum())
    if counts is not None:
        mass = mass / np.maximum(counts[source_ids], 1)
    _assert_ranking(got_v, got_i, sums, ULPS * F32_EPS * mass + 1e-30, np.asarray(jv),
                    np.asarray(ji))


@pytest.mark.parametrize("capacity", [3, 6, 40])
def test_bounded_topk_accumulate_bit_equal(capacity):
    """FixedCacheMap semantics, bit-equal to graphtpu's scan: values are
    multiples of 1/8 with repeats, so a new key often equals the current
    minimum and must not evict it (strictly greater only)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(-1, 12, size=(5, 60)).astype(np.int32)
    vals = (rng.integers(1, 9, size=(5, 60)) / 8).astype(np.float32)
    sk, sv = ttk.bounded_topk_accumulate(torch.from_numpy(keys), torch.from_numpy(vals),
                                         capacity)
    jk, jv = jtk.bounded_topk_accumulate(jnp.asarray(keys), jnp.asarray(vals), capacity)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    k = min(capacity, 4)
    tv, tk = ttk.bounded_slots_to_topk(sk, sv, k)
    jtv, jtk_ = jtk.bounded_slots_to_topk(jk, jv, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jtk_))
    # resuming from the slots of the first half gives the whole stream's slots
    h0, hv = ttk.bounded_topk_accumulate(torch.from_numpy(keys[:, :30]),
                                         torch.from_numpy(vals[:, :30]), capacity)
    rk, rv = ttk.bounded_topk_accumulate(torch.from_numpy(keys[:, 30:]),
                                         torch.from_numpy(vals[:, 30:]), capacity,
                                         init_keys=h0, init_values=hv)
    np.testing.assert_array_equal(rk.numpy(), sk.numpy())
    np.testing.assert_array_equal(rv.numpy(), sv.numpy())


def test_bounded_eviction_is_strictly_greater():
    keys = np.array([[1, 2, 3, 4]], np.int32)
    vals = np.array([[0.5, 0.25, 0.25, 0.75]], np.float32)
    sk, sv = ttk.bounded_topk_accumulate(torch.from_numpy(keys), torch.from_numpy(vals), 2)
    # 3 ties the minimum (0.25) and is dropped; 4 beats it and evicts key 2
    np.testing.assert_array_equal(sk.numpy(), [[1, 4]])
    np.testing.assert_array_equal(sv.numpy(), [[0.5, 0.75]])


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_segment_rows_sum_matmul_matches(compute):
    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 30, size=700).astype(np.int32)
    rows = rng.standard_normal((700, 6)).astype(np.float32)
    got_s, got_c = ttk.segment_rows_sum_matmul(torch.from_numpy(idx), torch.from_numpy(rows),
                                               30, chunk=256,
                                               compute_dtype=getattr(torch, compute))
    js, jc = jtk.segment_rows_sum_matmul(jnp.asarray(idx), jnp.asarray(rows), 30, chunk=256,
                                         compute_dtype=getattr(jnp, compute))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), rtol=0, atol=1e-6 * 30)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(got_c.numpy(), np.bincount(idx[idx >= 0], minlength=30))


def test_column_normalized_matches():
    rng = np.random.default_rng(5)
    a = (rng.random((9, 9)) < 0.3).astype(np.float32) * rng.random((9, 9)).astype(np.float32)
    a[:, 4] = 0  # an empty column stays zero
    got = column_normalized(torch.from_numpy(a)).numpy()
    # the column sums may add in another order: 4 float32 ulps
    np.testing.assert_allclose(got, np.asarray(j_column_normalized(jnp.asarray(a))),
                               rtol=ULPS * F32_EPS, atol=0)
    np.testing.assert_allclose(got.sum(axis=0)[a.sum(axis=0) > 0], 1.0, rtol=ULPS * F32_EPS)
    assert (got[:, 4] == 0).all()
