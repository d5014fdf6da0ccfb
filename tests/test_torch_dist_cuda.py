"""graphtpu_torch.dist on an NVIDIA GPU: 4 gloo ranks sharing the card run
the sharded exact SimRank (the 1-D ring in f32 and bf16, 2-D SUMMA on a
2x2 grid, the dense form) against the single-device tree path on the same
card, each rank launching kernel B3; then every dist entry point once at
world size 1 under NCCL (the dry run's steps).  Every test needs a card
and skips without one.  This file imports neither jax nor graphtpu:

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py

Tolerances: f32 scores within 1e-6 of ``exact_simrank_spmm(impl="tree")``
(the same B3 products, the row scale applied at a shard's last level
rather than the global tree's); the dense form within 1e-6 of the
single-device dense engine; bf16 iterates within 4 bf16 ulps of the tree
path's bf16 run (the ring rounds P·S to bf16 and multiplies by c rounded
to bf16, as graphtpu's ring does, where the tree path keeps P·S in f32
and scales in f32: 3 ulps at most on the CPU at V = 256 and 2,048).

The dense form's ``matmul_precision`` on the card: "high" bit-equal to
"highest" in every rank, "default" (TF32) different but within
2·k·2^-11 after k iterations (derived in tests/test_torch_models_cuda.py).
SGNS's model axis on the card: 5 steps on a (1, 4) mesh equal one card's
steps by gradient rows (``sgns_step``'s update of ``_segment_grads``, the
order of sums the mesh keeps) bit for bit, and one card's ``sgns_step``
(which sums by SG1, in another order) within 1e-5; on a (2, 2) mesh
within 1e-5 of the steps by gradient rows (the data axis sums each row in
two blocks).
"""

import numpy as np
import pytest
import torch

from graphtpu_torch.dist import mesh as tm

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
V, E = 2048, 16_000
TOL_F32 = 1e-6
BF16_ULPS = 4
TF32_ITERATIONS = 5
TF32_BOUND = 2 * TF32_ITERATIONS * 2.0 ** -11
TOL_SGNS = {2: 1e-5, 4: 0.0}   # model_parallel -> SGNS shards vs one card
TOL_SGNS_SG1 = 1e-5            # the (1, 4) mesh vs one card's sgns_step (SG1)
SGNS_V, SGNS_STEPS = 5000, 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _edges():
    rng = np.random.default_rng(3)
    e = rng.integers(0, V, size=(E, 2))
    ring = np.stack([np.arange(V), (np.arange(V) + 1) % V], 1)
    return np.concatenate([e[e[:, 0] != e[:, 1]], ring])


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.double().abs())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8), 0.0)


def _sharded_on_card(device):
    """Every form on this rank against the single-device references on the
    same card; returns, gathered over the ranks, each form's error and B3's
    launches in its run."""
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.config import SimRankConfig
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.dist.spmm_sharded import sharded_simrank_spmm
    from graphtpu_torch.dist.spmm_summa import summa_simrank_spmm
    from graphtpu_torch.kernels import spmm
    from graphtpu_torch.simrank.exact import exact_simrank, exact_simrank_spmm

    cfg = SimRankConfig(iterations=3)
    g = build_graph(_edges(), n_nodes=V)
    mesh = tm.make_1d_mesh(device=device)
    grid = tm.make_2d_mesh(2, 2, device=device)
    dev = mesh.device
    runs = {
        "ring_f32": lambda: sharded_simrank_spmm(g, mesh, cfg),
        "ring_bf16": lambda: sharded_simrank_spmm(g, mesh, cfg, dtype=torch.bfloat16),
        "summa_f32": lambda: summa_simrank_spmm(g, grid, cfg),
        "dense": lambda: sharded_exact_simrank(g, mesh, cfg),
    }
    blocks, launches = {}, {}
    for name, fn in runs.items():
        spmm.GATHER_LAUNCHES["gather_rows_sum"] = 0
        blocks[name] = fn()
        torch.cuda.synchronize()
        launches[name] = spmm.GATHER_LAUNCHES["gather_rows_sum"]
    tree = exact_simrank_spmm(g, cfg, impl="tree", device=dev)
    tree16 = exact_simrank_spmm(g, cfg, impl="tree", dtype=torch.bfloat16, device=dev).float()
    dense = exact_simrank(g, cfg, device=dev)
    errs = {}
    for name, b in blocks.items():
        ref = {"ring_bf16": tree16, "dense": dense}.get(name, tree)
        ref = ref[b.row_lo: b.row_lo + b.values.shape[0], b.col_lo: b.col_lo + b.values.shape[1]]
        d = (b.values.float() - ref).abs()
        if name == "ring_bf16":
            d = torch.where(ref != 0, d / _bf16_ulp(ref).float(), d * 1e9)  # in ulps
        errs[name] = d.max().item()
    row = torch.tensor([[errs[k], launches[k]] for k in runs], dtype=torch.float64)
    return list(runs), tm.all_gather(row.to(dev), mesh.groups["data"]).cpu().numpy()


def test_sharded_simrank_on_card_matches_tree(cuda):
    names, per_rank = tm.spawn(_sharded_on_card, 4, "gloo", "cuda", timeout=600)
    for k, name in enumerate(names):
        errs, launches = per_rank[:, k, 0], per_rank[:, k, 1]
        if name == "dense":
            assert (launches == 0).all(), name  # cuBLAS matmuls, no B3
            assert errs.max() <= TOL_F32, (name, errs)
            continue
        assert (launches > 0).all(), (name, launches)  # B3 in every rank
        bound = BF16_ULPS if name == "ring_bf16" else TOL_F32
        assert errs.max() <= bound, (name, errs)


def test_every_entry_point_under_nccl(cuda):
    from graphtpu_torch.dryrun import _rank

    line = tm.spawn(_rank, 1, "nccl", "cuda", args=(1,), timeout=600)
    assert line.startswith("nccl on cuda:0") and "SUMMA" in line, line


def _sgns_batches(device):
    rng = np.random.default_rng(11)
    b, w, n = 1024, 10, 5
    return [tuple(torch.from_numpy(x).to(device) for x in (
        rng.integers(-1, SGNS_V, b).astype(np.int32),
        rng.integers(0, SGNS_V, (b, w)).astype(np.int32),
        rng.random((b, w)) < 0.8,
        rng.integers(0, SGNS_V, (b, n)).astype(np.int32))) for _ in range(SGNS_STEPS)]


def _precision_and_model_axis(device):
    """Each rank: its dense block at three precisions; SGNS steps on a
    (2, 2) and a (1, 4) mesh against one card's steps by gradient rows on
    the same device, and the (1, 4) mesh against one card's
    ``sgns_step``.  Returns every rank's row of numbers."""
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.config import SGNSConfig, SimRankConfig
    from graphtpu_torch.core.device import full_fp32
    from graphtpu_torch.dist.sgns_dp import make_sgns_train_step, row_shards
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.models.sgns import _segment_grads, sgns_step

    mesh = tm.make_1d_mesh(device=device)
    dev = mesh.device
    g = build_graph(_edges(), n_nodes=V)
    cfg = SimRankConfig(iterations=TF32_ITERATIONS)
    blk = {p: sharded_exact_simrank(g, mesh, cfg, matmul_precision=p).values
           for p in ("highest", "high", "default")}
    row = [float(torch.equal(blk["high"], blk["highest"])),
           (blk["default"] - blk["highest"]).abs().max().item()]
    rng = np.random.default_rng(12)
    tables = [rng.normal(scale=0.1, size=(SGNS_V, 32)).astype(np.float32) for _ in range(2)]
    batches = _sgns_batches(dev)
    one = fused = tuple(torch.from_numpy(t).to(dev) for t in tables)
    with full_fp32():
        for i, b in enumerate(batches):
            (g0, g1), (c0, c1) = _segment_grads(one, *b, SGNS_V)
            lr = 0.025 - 0.002 * i
            one = (one[0] - lr * (g0 / c0.clamp(min=1)[:, None]),
                   one[1] - lr * (g1 / c1.clamp(min=1)[:, None]))
            fused = sgns_step(fused, *b, lr, SGNS_V)
    for mp in TOL_SGNS:
        m = tm.make_mesh(model_parallel=mp, device=device)
        sh = row_shards(m, SGNS_V)
        shard_params, shard_batch, train_step = make_sgns_train_step(m, SGNSConfig(dim=32),
                                                                     SGNS_V)
        params = shard_params(tables)
        for i, b in enumerate(batches):
            params = train_step(params, *shard_batch(*b), 0.025 - 0.002 * i)
        hi = min(sh.lo + sh.rows, SGNS_V)
        row.append(max((p[: hi - sh.lo] - o[sh.lo: hi]).abs().max().item()
                       for p, o in zip(params, one)))
        if mp == 4:
            last = max((p[: hi - sh.lo] - o[sh.lo: hi]).abs().max().item()
                       for p, o in zip(params, fused))
    row.append(last)
    return tm.all_gather(torch.tensor(row, dtype=torch.float64, device=dev),
                         mesh.groups["data"]).cpu().numpy()


def test_precision_and_model_axis_on_card(cuda):
    per_rank = tm.spawn(_precision_and_model_axis, 4, "gloo", "cuda", timeout=600)
    assert (per_rank[:, 0] == 1).all()                  # "high" is "highest"'s bits
    assert (per_rank[:, 1] <= TF32_BOUND).all() and per_rank[:, 1].max() > 0, per_rank[:, 1]
    for k, (mp, tol) in enumerate(TOL_SGNS.items()):
        assert (per_rank[:, 2 + k] <= tol).all(), (mp, per_rank[:, 2 + k])
    assert (per_rank[:, -1] <= TOL_SGNS_SG1).all(), per_rank[:, -1]
