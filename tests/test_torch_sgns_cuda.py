"""SGNS's step kernel pair SG1 (``kernels/csrc/sgns.cu``) on an NVIDIA GPU
against its plain version (``models/sgns.py:_sgns_grads_plain``) on the
same card: at the node2vec cell's shape (B 8,192, 2w 20, N 5, D 128, V
16,384) and at other widths, windows and negatives; two launches give the
same bits; a captured and replayed step equals the eager step; a resumed
``train_sgns`` reproduces the uninterrupted run; every step of a card run
is formed by SG1 (``fused_steps``); per-pair negatives keep the segment
path; and the benchmark's ``bf16_grads`` control still moves the card's
steps.  Every test needs a card and skips without one.  This file imports
neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_sgns_cuda.py
"""

import numpy as np
import pytest
import torch

from benchmark import readings_node2vec
from graphtpu_torch.bench.sgns_probe import cell_batch, grads_differ
from graphtpu_torch.core.config import SGNSConfig
from graphtpu_torch.models import checkpoint as ckpt
from graphtpu_torch.models import sgns

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cell(cuda):
    return cell_batch(cuda, seed=3)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))


def test_sg1_matches_plain_at_the_cell_shape(cell):
    params, batch, v = cell
    assert tuple(batch[1].shape) == (8192, 20) and tuple(batch[3].shape) == (8192, 5)
    launched = dict(sgns.SG1_LAUNCHES)
    got = sgns.sgns_manual_grads(params, *batch, v)
    assert sgns.SG1_LAUNCHES == {k: x + 1 for k, x in launched.items()}
    want = sgns._sgns_grads_plain(params, *batch, v)
    assert grads_differ(got, want) == ""
    assert int(want[1][1].max()) > 2 * sgns.SG1_CHUNK  # hub rows cross chunks
    assert int((batch[0] < 0).sum()) > 0 and not bool(batch[2].all())


def test_sg1_stages_match_their_plain_versions(cell):
    """SG1a: the keys equal, the coefficients and dv within float32
    summation error; SG1b on the plain version's own (g, dv, keys): the
    same additions in the same order, so the same bits."""
    params, batch, v = cell
    g, dv, keys = sgns.sg1_coeffs(params, *batch, v)
    pg, pdv, pkeys = sgns._sg1_coeffs_plain(params, *batch, v)
    assert torch.equal(keys, pkeys)
    torch.testing.assert_close(g, pg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, pdv, rtol=1e-5, atol=1e-5 * float(pdv.abs().max()))
    w2 = batch[1].shape[1]
    got = sgns.sg1_rows(params[0], batch[0], pg, pdv, pkeys, w2, v)
    want = sgns._sg1_rows_plain(params[0], batch[0], pg, pdv, pkeys, w2, v)
    assert grads_differ(got, want) == ""


@pytest.mark.parametrize("d,window,neg", [(8, 3, 4), (32, 4, 5), (100, 10, 5), (128, 20, 3),
                                          (256, 5, 2), (512, 2, 7)])
def test_sg1_matches_plain_at_other_shapes(cuda, d, window, neg):
    """Widths of 1, 4, 8 and 16 columns a lane (and a ragged 100), windows
    past one warp's 32 slots, and hub rows."""
    gen = torch.Generator(device=cuda).manual_seed(d + window)
    v, b = 700, 1500
    params = tuple(0.3 * torch.randn((v, d), generator=gen, device=cuda) for _ in range(2))
    centers = torch.randint(-1, v, (b,), generator=gen, device=cuda, dtype=torch.int32)
    contexts = torch.randint(0, v, (b, 2 * window), generator=gen, device=cuda,
                             dtype=torch.int32)
    contexts[torch.rand(contexts.shape, generator=gen, device=cuda) < 0.2] = 7  # a hub
    mask = torch.rand(contexts.shape, generator=gen, device=cuda) < 0.7
    negs = torch.randint(0, v, (b, neg), generator=gen, device=cuda, dtype=torch.int32)
    negs[::3, 0] = contexts[::3, 0]
    got = sgns.sg1_grads(params, centers, contexts, mask, negs, v)
    want = sgns._sgns_grads_plain(params, centers, contexts, mask, negs, v)
    assert grads_differ(got, want) == ""


def test_sg1_launches_give_equal_bits(cell):
    params, batch, v = cell
    first = sgns.sg1_grads(params, *batch, v)
    for _ in range(2):
        assert _equal(sgns.sg1_grads(params, *batch, v), first)


def test_captured_step_equals_the_eager_step(cell, cuda):
    params, batch, v = cell
    eager = sgns.sgns_step(params, *batch, 0.02, v)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        sgns.sgns_step(params, *batch, 0.02, v)  # lazy set-up off the graph
        graph.capture_begin()
        out = sgns.sgns_step(params, *batch, 0.02, v)
        graph.capture_end()
    torch.cuda.current_stream(cuda).wait_stream(side)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def _walks(cuda):
    from graphtpu_torch.bench.generators import rmat_graph
    from graphtpu_torch.core.graph import build_graph
    from graphtpu_torch.walks.walker import simulate_walks

    g = build_graph(rmat_graph(11, 20_000, seed=1), n_nodes=2048, device=cuda)
    return simulate_walks(g, 4, 40, 5, device=cuda), g.n_nodes


CFG = SGNSConfig(dim=128, window=10, epochs=2, batch_size=1024)


def test_resumed_run_on_the_card_reproduces_the_uninterrupted_one(cuda, tmp_path):
    walks, v = _walks(cuda)
    saved, orig = [], ckpt.save_state

    def capture(path, arrays, step=0, meta=None):
        saved.append(({k: np.array(x) for k, x in arrays.items()}, step, dict(meta or {})))
        orig(path, arrays, step=step, meta=meta)

    ckpt.save_state = capture
    try:
        whole = sgns.train_sgns(walks, v, CFG, chunk_steps=20, device=cuda,
                                checkpoint_path=str(tmp_path / "a.npz"), checkpoint_every=1)
    finally:
        ckpt.save_state = orig
    mid = saved[len(saved) // 2 + 1]  # inside the second epoch
    orig(str(tmp_path / "mid.npz"), mid[0], step=mid[1], meta=mid[2])
    resumed = sgns.train_sgns(walks, v, CFG, chunk_steps=20, device=cuda,
                              checkpoint_path=str(tmp_path / "mid.npz"))
    assert np.array_equal(resumed[0], whole[0]) and np.array_equal(resumed[1], whole[1])


def test_every_card_step_is_fused(cuda):
    walks, v = _walks(cuda)
    before = dict(sgns.SGNS_COUNTS)
    sgns.train_sgns(walks, v, CFG, chunk_steps=20, device=cuda)
    counted = {k: sgns.SGNS_COUNTS[k] - before[k] for k in before}
    assert counted["steps"] == 2 * (walks.numel() // 1024) > 0
    assert counted["fused_steps"] == counted["steps"]


def test_per_pair_negatives_keep_the_segment_path(cell):
    params, (centers, contexts, mask, negs), v = cell
    per_pair = negs[:, None, :].expand(-1, contexts.shape[1], -1).contiguous()
    launched = dict(sgns.SG1_LAUNCHES)
    got = sgns.sgns_manual_grads(params, centers, contexts, mask, per_pair, v)
    assert sgns.SG1_LAUNCHES == launched
    assert _equal(got, sgns._segment_grads(params, centers, contexts, mask, per_pair, v))


def test_bf16_grads_control_moves_the_card_steps(cuda):
    walks, v = _walks(cuda)
    cfg = SGNSConfig(dim=128, window=10, epochs=1, batch_size=1024)
    program = sgns.train_sgns(walks, v, cfg, device=cuda)
    before = dict(sgns.SGNS_COUNTS)
    with readings_node2vec.bf16_grads():
        control = sgns.train_sgns(walks, v, cfg, device=cuda)
    counted = {k: sgns.SGNS_COUNTS[k] - before[k] for k in before}
    assert counted["fused_steps"] == counted["steps"] > 0
    assert not np.array_equal(program[0], control[0])
    assert not np.array_equal(program[1], control[1])
