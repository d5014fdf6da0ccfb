"""graphtpu_torch's SGNS trainer against graphtpu's.

Deterministic pieces take the same numpy inputs in both packages and are
compared exactly (counts, the alias table, a batch's windows) or to a
stated float32 tolerance (losses, gradients, one step); training, whose
random streams differ, is held to graphtpu's own tests: it learns the
two-clique structure and a resumed run reproduces an uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.core.config import SGNSConfig as JSGNSConfig
from graphtpu.kernels.topk import segment_rows_sum as j_segment_rows_sum
from graphtpu.models import sgns as jsgns
from graphtpu_torch import build_graph
from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.core.convert import params_from_numpy
from graphtpu_torch.kernels.topk import segment_rows_sum
from graphtpu_torch.models import checkpoint as tckpt
from graphtpu_torch.models import sgns as tsgns
from graphtpu_torch.walks.walker import simulate_walks

torch.set_num_threads(1)
CPU = "cpu"
TOL_GRAD = 2e-5   # float32 sums of a few dozen terms of size ~1, in another order


def _batch(seed, v=20, d=8, b=6, w=3, neg=4, shared=False):
    rng = np.random.default_rng(seed)
    params = [rng.normal(scale=0.5, size=(v, d)).astype(np.float32) for _ in range(2)]
    centers = rng.integers(0, v, b).astype(np.int32)
    centers[1] = -1  # a padding center
    contexts = rng.integers(0, v, (b, 2 * w)).astype(np.int32)
    mask = rng.random((b, 2 * w)) < 0.7
    negs = rng.integers(0, v, (b, neg) if shared else (b, 2 * w, neg)).astype(np.int32)
    negs.reshape(-1)[:3] = contexts.reshape(-1)[:3]  # accidental hits
    return params, centers, contexts, mask, negs


def _both(arrs):
    """(jax arrays, torch tensors) of the same numpy inputs."""
    params, *rest = arrs
    j = (tuple(jnp.asarray(p) for p in params), *(jnp.asarray(x) for x in rest))
    t = (params_from_numpy(*params, CPU), *(torch.from_numpy(x) for x in rest))
    return j, t


def test_corpus_counts_matches():
    walks = np.random.default_rng(0).integers(-1, 9, size=(30, 7)).astype(np.int32)
    got = tsgns.corpus_counts(torch.from_numpy(walks), 10).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsgns.corpus_counts(jnp.asarray(walks), 10)))
    assert got[9] == 0 and got.sum() == (walks >= 0).sum()


def test_negative_tables_match():
    counts = np.array([16, 81, 1, 0, 256, 7], np.int64)
    j, q = tsgns.build_negative_alias(torch.from_numpy(counts))
    jj, jq = jsgns.build_negative_alias(jnp.asarray(counts))
    assert j.dtype == torch.int32 and q.dtype == torch.float32
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tsgns.build_negative_cdf(torch.from_numpy(counts)).numpy(),
                               np.asarray(jsgns.build_negative_cdf(jnp.asarray(counts))),
                               rtol=1e-6)


def test_negative_alias_matches_unigram_distribution():
    counts = torch.tensor([16.0, 81.0, 1.0, 0.0, 256.0])
    j, q = tsgns.build_negative_alias(counts)
    samples = tsgns.alias_draw_batch(j, q, torch.Generator().manual_seed(0), (200_000,))
    assert samples.dtype == torch.int32
    emp = np.bincount(samples.numpy(), minlength=5) / samples.numel()
    w = counts.numpy() ** 0.75
    assert emp[3] == 0.0  # zero-count token never drawn
    np.testing.assert_allclose(emp, w / w.sum(), atol=5e-3)


def test_segment_rows_sum_matches_graphtpu():
    rng = np.random.default_rng(1)
    n, d, v = 500, 16, 37
    idx = rng.integers(-1, v, n).astype(np.int32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    sums, counts = segment_rows_sum(torch.from_numpy(idx), torch.from_numpy(rows), v)
    js, jc = j_segment_rows_sum(jnp.asarray(idx), jnp.asarray(rows), v)
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.dtype == torch.float32
    again = segment_rows_sum(torch.from_numpy(idx), torch.from_numpy(rows), v)[0]
    assert torch.equal(sums, again)


@pytest.mark.parametrize("shared", [False, True])
def test_loss_and_manual_grads_match_graphtpu(shared):
    arrs = _batch(3 if shared else 0, shared=shared)
    (jp, *jr), (tp, *tr) = _both(arrs)
    np.testing.assert_allclose(tsgns.sgns_loss(tp, *tr).item(),
                               float(jsgns.sgns_loss(jp, *jr)), atol=TOL_GRAD)
    (g0, g1), (c0, c1) = tsgns.sgns_manual_grads(tp, *tr, 20)
    (jg0, jg1), (jc0, jc1) = jsgns.sgns_manual_grads(jp, *jr, 20)
    np.testing.assert_allclose(g0.numpy(), np.asarray(jg0), atol=TOL_GRAD)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), atol=TOL_GRAD)
    np.testing.assert_array_equal(c0.numpy(), np.asarray(jc0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))


@pytest.mark.parametrize("shared", [False, True])
def test_manual_grads_match_autograd(shared):
    arrs = _batch(5, shared=shared)
    _, (tp, *tr) = _both(arrs)
    leaf = tuple(p.clone().requires_grad_(True) for p in tp)
    tsgns.sgns_loss(leaf, *tr).backward()
    (g0, g1), (c0, c1) = tsgns.sgns_manual_grads(tp, *tr, 20)
    np.testing.assert_allclose(g0.numpy(), leaf[0].grad.numpy(), atol=TOL_GRAD)
    np.testing.assert_allclose(g1.numpy(), leaf[1].grad.numpy(), atol=TOL_GRAD)
    centers, contexts, mask, negs = arrs[1:]
    np.testing.assert_array_equal(c0.numpy(), np.bincount(centers[centers >= 0], minlength=20))
    hits = np.concatenate([contexts[mask], negs.reshape(-1)])
    np.testing.assert_array_equal(c1.numpy(), np.bincount(hits, minlength=20))


def test_gather_batch_matches_graphtpu_exactly():
    rng = np.random.default_rng(2)
    walks = rng.integers(0, 50, size=(40, 12)).astype(np.int32)
    for r, cut in enumerate(rng.integers(3, 13, size=40)):
        walks[r, cut:] = -1  # compacted rows: -1 tails
    slots = rng.integers(0, walks.size, size=256)
    key, window = jax.random.key(11), 4
    # graphtpu draws b = randint(key, (B,), 1, window+1) inside; feed the port the same
    b = jax.random.randint(key, (256,), 1, window + 1)
    got = tsgns._gather_batch(torch.from_numpy(walks), torch.from_numpy(slots), window,
                              torch.from_numpy(np.array(b)))
    want = jsgns._gather_batch(jnp.asarray(walks), jnp.asarray(slots), window, key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shared", [False, True])
def test_sgns_step_matches_graphtpu_step_body(shared):
    arrs = _batch(7, shared=shared)
    (jp, *jr), (tp, *tr) = _both(arrs)
    lr = 0.0173
    (g0, g1), (c0, c1) = jsgns.sgns_manual_grads(jp, *jr, 20)
    want0 = jp[0] - lr * g0 / jnp.maximum(c0, 1)[:, None]
    want1 = jp[1] - lr * g1 / jnp.maximum(c1, 1)[:, None]
    s0, s1 = tsgns.sgns_step(tp, *tr, lr, 20)
    np.testing.assert_allclose(s0.numpy(), np.asarray(want0), atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(want1), atol=1e-6)


def test_subsample_keep_rates_and_compaction():
    walks = np.tile(np.array([[5, 0, 5, 1, 5, 2]], np.int32), (4000, 1))
    walks[::7, 4:] = -1
    counts = np.bincount(walks[walks >= 0], minlength=6)
    sample = 1e-1
    out, mask = tsgns.subsample_and_compact(torch.from_numpy(walks), torch.from_numpy(counts),
                                            sample, torch.Generator().manual_seed(0))
    out = out.numpy()
    assert torch.equal(mask, torch.from_numpy(out >= 0))
    for row, src in zip(out, walks):  # kept tokens first, in their order
        kept = row[row >= 0]
        assert (row[len(kept):] == -1).all()
        it = iter(src[src >= 0].tolist())
        assert all(any(x == y for y in it) for x in kept.tolist())
    freq = counts / counts.sum()
    keep_p = np.clip((np.sqrt(freq / sample) + 1) * sample / np.maximum(freq, 1e-12), 0, 1)
    jout, _ = jsgns.subsample_and_compact(jnp.asarray(walks), jnp.asarray(counts), sample,
                                          jax.random.key(0))
    jout = np.asarray(jout)
    for tok in range(6):
        rate = (out == tok).sum() / max((walks == tok).sum(), 1)
        jrate = (jout == tok).sum() / max((walks == tok).sum(), 1)
        if counts[tok]:
            assert abs(rate - keep_p[tok]) < 0.03 and abs(jrate - keep_p[tok]) < 0.03, tok
    same, _ = tsgns.subsample_and_compact(torch.from_numpy(walks), torch.from_numpy(counts), 0,
                                          None)
    assert torch.equal(same, torch.from_numpy(walks))  # sample 0: nothing dropped


def test_sgns_learns_structure():
    """Two disjoint cliques: intra-clique similarity beats inter."""
    edges = [[base + i, base + j] for base in (0, 8) for i in range(8) for j in range(i + 1, 8)]
    g = build_graph(np.array(edges), n_nodes=16)
    walks = simulate_walks(g, num_walks=30, walk_length=20, key=0, device=CPU)
    cfg = SGNSConfig(dim=16, window=4, epochs=10, batch_size=64, subsample=0)
    syn0, _ = tsgns.train_sgns(walks, 16, cfg, device=CPU)
    e = syn0 / np.linalg.norm(syn0, axis=1, keepdims=True)
    sims = e @ e.T
    intra = ((sims[:8, :8].sum() - 8) / 56 + (sims[8:, 8:].sum() - 8) / 56) / 2
    inter = sims[:8, 8:].mean()
    assert intra > inter + 0.3, (intra, inter)


@pytest.fixture(scope="module")
def small_walks(small_random):
    from graphtpu_torch.core.graph import graph_from_numpy

    g = graph_from_numpy(*(np.asarray(a) for a in (small_random.row_ptr, small_random.col)),
                         None, np.asarray(small_random.deg))
    return simulate_walks(g, num_walks=4, walk_length=16, key=0, device=CPU)


def _capture_saves(monkeypatch, module):
    """Record every checkpoint ``module.save_state`` writes."""
    saved, orig = [], module.save_state

    def capture(path, arrays, step=0, meta=None):
        saved.append(({k: np.array(v) for k, v in arrays.items()}, step, dict(meta or {})))
        orig(path, arrays, step=step, meta=meta)

    monkeypatch.setattr(module, "save_state", capture)
    return saved, orig


def test_train_resume_reproduces_uninterrupted_run(tmp_path, small_walks, monkeypatch):
    cfg = SGNSConfig(dim=8, window=2, epochs=2, batch_size=64, subsample=1e-2)
    full0, full1 = tsgns.train_sgns(small_walks, 64, cfg, chunk_steps=10, device=CPU)
    again0, _ = tsgns.train_sgns(small_walks, 64, cfg, chunk_steps=10, device=CPU)
    np.testing.assert_array_equal(full0, again0)
    saved, orig = _capture_saves(monkeypatch, tckpt)
    tsgns.train_sgns(small_walks, 64, cfg, chunk_steps=10,
                     checkpoint_path=str(tmp_path / "a.npz"), checkpoint_every=1, device=CPU)
    assert saved[-1][2] == {"epoch": 2, "next_start": 0}
    assert len(saved) > 3
    mid = saved[len(saved) // 2]
    orig(str(tmp_path / "mid.npz"), mid[0], step=mid[1], meta=mid[2])
    r0, r1 = tsgns.train_sgns(small_walks, 64, cfg, chunk_steps=10,
                              checkpoint_path=str(tmp_path / "mid.npz"), device=CPU)
    np.testing.assert_allclose(r0, full0, atol=1e-5)
    np.testing.assert_allclose(r1, full1, atol=1e-5)


def test_graphtpu_checkpoint_resumes_in_port(tmp_path, small_random, small_walks, monkeypatch):
    import graphtpu.models.checkpoint as jckpt
    from graphtpu.walks.walker import simulate_walks as j_simulate_walks

    jwalks = j_simulate_walks(small_random, num_walks=4, walk_length=16, key=jax.random.key(0))
    jcfg = JSGNSConfig(dim=8, window=2, epochs=2, batch_size=64, subsample=0)
    saved, orig = _capture_saves(monkeypatch, jckpt)
    j0, j1 = jsgns.train_sgns(jwalks, 64, jcfg, chunk_steps=10,
                              checkpoint_path=str(tmp_path / "j.npz"), checkpoint_every=1)
    arrays, step, meta = tckpt.load_state(str(tmp_path / "j.npz"))
    assert meta == {"epoch": 2, "next_start": 0} and step == len(saved)
    np.testing.assert_array_equal(arrays["syn0"], j0)
    cfg = SGNSConfig(dim=8, window=2, epochs=2, batch_size=64, subsample=0)
    walks = torch.from_numpy(np.asarray(jwalks))
    # a finished run's checkpoint: the port resumes past its last step
    f0, f1 = tsgns.train_sgns(walks, 64, cfg, chunk_steps=10,
                              checkpoint_path=str(tmp_path / "j.npz"), device=CPU)
    np.testing.assert_array_equal(f0, j0)
    np.testing.assert_array_equal(f1, j1)
    # a mid-run checkpoint: the port trains the remaining chunks from it
    mid = saved[len(saved) // 2]
    orig(str(tmp_path / "mid.npz"), mid[0], step=mid[1], meta=mid[2])
    m0, _ = tsgns.train_sgns(walks, 64, cfg, chunk_steps=10,
                             checkpoint_path=str(tmp_path / "mid.npz"), device=CPU)
    assert np.isfinite(m0).all() and not np.array_equal(m0, mid[0]["syn0"])


def test_graphtpu_tables_give_graphtpu_loss(small_random):
    from graphtpu.walks.walker import simulate_walks as j_simulate_walks

    jwalks = j_simulate_walks(small_random, num_walks=2, walk_length=10, key=jax.random.key(1))
    j0, j1 = jsgns.train_sgns(jwalks, 64, JSGNSConfig(dim=8, window=2, epochs=1, batch_size=64))
    params = params_from_numpy(j0, j1, CPU)
    assert params[0].dtype == torch.float32
    for shared in (False, True):
        arrs = _batch(9, v=64, shared=shared)
        (_, *jr), (_, *tr) = _both(arrs)
        want = float(jsgns.sgns_loss((jnp.asarray(j0), jnp.asarray(j1)), *jr))
        np.testing.assert_allclose(tsgns.sgns_loss(params, *tr).item(), want, rtol=1e-6)


def test_train_sgns_raises_without_card(small_walks, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsgns.train_sgns(small_walks, 64, SGNSConfig(dim=8, epochs=1))


# SG1 (kernels/csrc/sgns.cu) runs on a card only; here its plain version
# (_sgns_grads_plain) is held to graphtpu, and its row sums to SG1b's
# order of additions.

SG1_V, SG1_B, SG1_W2, SG1_N = 40, 64, 6, 4


def _sg1_case(case, seed=21, d=8):
    """A shared-negatives batch of SG1_B centers over SG1_V rows for one
    of the cases SG1 must take."""
    rng = np.random.default_rng(seed)
    v, b, w2, n = SG1_V, SG1_B, SG1_W2, SG1_N
    params = [rng.normal(scale=0.5, size=(v, d)).astype(np.float32) for _ in range(2)]
    centers = rng.integers(0, v, b).astype(np.int32)
    contexts = rng.integers(0, v, (b, w2)).astype(np.int32)
    mask = rng.random((b, w2)) < 0.8
    negs = rng.integers(0, v, (b, n)).astype(np.int32)
    if case == "masked":
        mask &= rng.random((b, w2)) < 0.5
        mask[:8] = False  # centers with no valid slot
        contexts[~mask] = -1
    elif case == "dead_centers":
        centers[::5] = -1  # their valid slots count, and move nothing
    elif case == "accidental_hits":
        negs[:, 0] = contexts[:, 0]
        negs[:, 1] = centers
        negs[::3, 2] = contexts[::3, 1]
    elif case == "repeated_row":
        contexts[:4] = 5
        negs[:4] = 5
        centers[:4] = 5
    elif case == "hub":  # one row with more items than SG1b's chunk
        contexts[rng.random((b, w2)) < 0.4] = 3
        negs[:, 1] = 3
        centers[::4] = 3
        mask[contexts == 3] = True
    return params, centers, contexts, mask, negs


def _sg1_batch_tensors(case="hub"):
    (p0, p1), *rest = _sg1_case(case)
    return (torch.from_numpy(p0), torch.from_numpy(p1)), [torch.from_numpy(x) for x in rest]


SG1_CASES = ["masked", "dead_centers", "accidental_hits", "repeated_row", "hub"]


@pytest.mark.parametrize("case", SG1_CASES)
def test_sg1_plain_matches_graphtpu(case):
    arrs = _sg1_case(case)
    (jp, *jr), (tp, *tr) = _both(arrs)
    (jg0, jg1), (jc0, jc1) = jsgns.sgns_manual_grads(jp, *jr, SG1_V)
    (g0, g1), (c0, c1) = tsgns._sgns_grads_plain(tp, *tr, SG1_V)
    np.testing.assert_allclose(g0.numpy(), np.asarray(jg0), atol=TOL_GRAD)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), atol=TOL_GRAD)
    np.testing.assert_array_equal(c0.numpy(), np.asarray(jc0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    if case == "hub":
        assert c1[3] > 2 * tsgns.SG1_CHUNK


def _chunk_order_sums(keys, items, rows, chunk):
    """Each row's items in the keys' stable order, added one float32 at a
    time within each chunk of ``chunk`` sorted items, then the chunks'
    sums in chunk order: the order SG1b sums in."""
    order = np.argsort(keys, kind="stable")
    pos_of = np.argsort(order, kind="stable")  # an item's sorted position
    out = np.zeros((rows, items.shape[1]), np.float32)
    for r in np.unique(keys):
        mine = np.flatnonzero(keys == r)  # item order = sorted order within a key
        total = np.zeros(items.shape[1], np.float32)
        for q in np.unique(pos_of[mine] // chunk):
            part = np.zeros(items.shape[1], np.float32)
            for i in mine[pos_of[mine] // chunk == q]:
                part = part + items[i]
            total = total + part
        out[r] = total
    return out


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("case", SG1_CASES)
def test_sg1_rows_plain_sums_in_chunk_order(case, chunk):
    """The plain version of SG1b adds each row's items in SG1b's order (the
    card tests hold SG1b to it bit for bit) and counts them."""
    tables, (centers, contexts, mask, negs) = _sg1_batch_tensors(case)
    g, dv, keys = tsgns._sg1_coeffs_plain(tables, centers, contexts, mask, negs, SG1_V)
    (g0, g1), (c0, c1) = tsgns._sg1_rows_plain(tables[0], centers, g, dv, keys, SG1_W2, SG1_V,
                                               chunk)
    d, v = dv.shape[1], SG1_V
    vc = tables[0][centers.clamp(min=0)]
    items = torch.cat([(g[:, :SG1_W2, None] * vc[:, None]).reshape(-1, d),
                       (g[:, SG1_W2:, None] * vc[:, None]).reshape(-1, d), dv]).numpy()
    keys = keys.numpy()
    out = _chunk_order_sums(keys, items, 2 * v + 1, chunk)
    counts = np.bincount(keys, minlength=2 * v + 1).astype(np.float32)
    np.testing.assert_array_equal(out[:v], g1.numpy())
    np.testing.assert_array_equal(out[v + 1:], g0.numpy())
    np.testing.assert_array_equal(counts[:v], c1.numpy())
    np.testing.assert_array_equal(counts[v + 1:], c0.numpy())


def test_sg1_keys_and_coefficients():
    """SG1a's keys: a context's id where its mask holds (else the skip key
    V), every negative's id, V + 1 + c for a center c >= 0 (else V); a
    masked slot's and a dead center's coefficients are 0."""
    _, centers, contexts, mask, negs = _sg1_case("dead_centers")
    t, batch = _sg1_batch_tensors("dead_centers")
    g, dv, keys = tsgns._sg1_coeffs_plain(t, *batch, SG1_V)
    b, w2, v = SG1_B, SG1_W2, SG1_V
    keys = keys.numpy()
    np.testing.assert_array_equal(keys[:b * w2], np.where(mask, contexts, v).reshape(-1))
    np.testing.assert_array_equal(keys[b * w2:-b], negs.reshape(-1))
    np.testing.assert_array_equal(keys[-b:], np.where(centers >= 0, centers + v + 1, v))
    g = g.numpy()
    assert (g[:, :w2][~mask] == 0).all() and (g[centers < 0] == 0).all()
    assert (dv.numpy()[centers < 0] == 0).all()
    assert (g[:, :w2][mask & (centers >= 0)[:, None]] < 0).all() and (g[:, w2:] >= 0).all()


@pytest.mark.parametrize("bad", ["f64_table", "widths", "wide", "batch", "per_pair", "device"])
def test_sg1_checks_raise(bad):
    params, (centers, contexts, mask, negs) = _sg1_batch_tensors()
    if bad == "f64_table":
        params = (params[0].double(), params[1])
    elif bad == "widths":
        params = (params[0], params[1][:, :4].contiguous())
    elif bad == "wide":
        params = tuple(torch.zeros((SG1_V, 520)) for _ in range(2))
    elif bad == "batch":
        centers = centers[:-1]
    elif bad == "per_pair":
        negs = negs[:, None, :].expand(-1, SG1_W2, -1)
    elif bad == "device":
        negs = negs.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tsgns.check_sg1_args(params, centers, contexts, mask, negs, SG1_V)


def test_cpu_steps_keep_the_segment_path():
    """On the CPU sgns_manual_grads launches nothing and gives the bits of
    sgns_closed_form summed by segment_rows_sum; train_sgns counts no
    fused step."""
    params, (centers, contexts, mask, negs) = _sg1_batch_tensors()
    launched = dict(tsgns.SG1_LAUNCHES)
    (g0, g1), (c0, c1) = tsgns.sgns_manual_grads(params, centers, contexts, mask, negs, SG1_V)
    assert tsgns.SG1_LAUNCHES == launched
    dv, du, dun = tsgns.sgns_closed_form(*tsgns._lookups(params, centers, contexts, negs),
                                         centers, contexts, mask, negs)
    want0, want_c0 = segment_rows_sum(centers, dv, SG1_V)
    idx1 = torch.cat([torch.where(mask, contexts, -1).reshape(-1), negs.reshape(-1)])
    want1, want_c1 = segment_rows_sum(idx1, torch.cat([du.reshape(-1, 8), dun.reshape(-1, 8)]),
                                      SG1_V)
    for got, want in ((g0, want0), (g1, want1), (c0, want_c0), (c1, want_c1)):
        assert torch.equal(got, want)
    walks = torch.from_numpy(np.random.default_rng(4).integers(0, 30, (40, 12)).astype(np.int32))
    before = dict(tsgns.SGNS_COUNTS)
    tsgns.train_sgns(walks, 30, SGNSConfig(dim=8, epochs=1, batch_size=64), device=CPU)
    assert tsgns.SGNS_COUNTS["steps"] > before["steps"]
    assert tsgns.SGNS_COUNTS["fused_steps"] == before["fused_steps"]
