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
