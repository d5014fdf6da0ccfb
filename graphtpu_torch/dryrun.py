"""Multi-rank dry run: every public ``dist`` entry point once on N local
ranks (counterpart of graphtpu's ``dryrun_multichip``,
``__graft_entry__.py:36-228``).

    python -m graphtpu_torch.dryrun N [--device cuda|cpu]

Exercises the parallel axes on a 64-node graph: the (data, model) mesh
(one SGNS step with the batch over ``data`` and the tables row-sharded
over a ``model`` axis of 2 ranks when N is even, as graphtpu's dry run
builds it), the frontier exchange (walks,
reuse UniWalk, TopSim and node2vec against a partitioned CSR), the source
windows with their durable cursor, and sharded exact SimRank (dense, the
1-D ring in f32 and bf16, 2-D SUMMA on an (N/2)x2 grid).  The backend
is NCCL where every rank has a card of its own and gloo
otherwise (CPU ranks, or ranks sharing a card).  Exits 0 and prints one
line ending in "OK" when every step ran.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch


def _rank(device, n):
    from graphtpu_torch import build_graph
    from graphtpu_torch.core.config import SGNSConfig, SimRankConfig, TopSimConfig, UniWalkConfig
    from graphtpu_torch.core.prng import key_for
    from graphtpu_torch.dist.frontier import distributed_uniform_walks
    from graphtpu_torch.dist.mesh import gather_rows, make_1d_mesh, make_2d_mesh, make_mesh
    from graphtpu_torch.dist.node2vec_dist import distributed_node2vec_walks
    from graphtpu_torch.dist.sgns_dp import make_sgns_train_step, train_sgns_dp
    from graphtpu_torch.dist.sharded_graph import shard_graph
    from graphtpu_torch.dist.simrank_sharded import sharded_exact_simrank
    from graphtpu_torch.dist.spmm_sharded import sharded_simrank_spmm
    from graphtpu_torch.dist.spmm_summa import summa_simrank_spmm
    from graphtpu_torch.dist.topsim_dist import distributed_topsim_simrank
    from graphtpu_torch.dist.uniwalk_dist import (
        distributed_uniwalk_simrank,
        distributed_uniwalk_simrank_reuse,
    )
    from graphtpu_torch.dist.windows import windowed_topk_sweep

    rng = np.random.default_rng(0)
    edges = rng.integers(0, 64, size=(256, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    ring = np.stack([np.arange(64), (np.arange(64) + 1) % 64], 1)
    g = build_graph(np.concatenate([edges, ring]), n_nodes=64)
    mesh = make_mesh(model_parallel=2 if n % 2 == 0 else 1, device=device)
    dev = mesh.device
    done = []

    # 1) one SGNS step: the batch over 'data', the tables row-sharded over 'model'
    shard_params, shard_batch, train_step = make_sgns_train_step(
        mesh, SGNSConfig(dim=32, window=2, negative=3), 64)
    params = shard_params((rng.normal(scale=0.01, size=(64, 32)).astype(np.float32),
                           np.zeros((64, 32), np.float32)))
    b = 4 * n
    params = train_step(params, *shard_batch(rng.integers(0, 64, b), rng.integers(0, 64, (b, 4)),
                                             np.ones((b, 4), bool),
                                             rng.integers(0, 64, (b, 4, 3))), 0.025)
    done.append(f"sgns step on a {mesh.shape[0]}x{mesh.shape[1]} mesh, shards "
                f"{tuple(params[0].shape)}")

    # 2) walk supersteps against a partitioned CSR
    mesh1 = make_1d_mesh(device=device)
    sg = shard_graph(g, n, mesh=mesh1)
    walks = distributed_uniform_walks(sg, 8 * n, 4, 0, mesh1)
    done.append(f"{(8 * n, walks.shape[1])} walks on a partitioned CSR")
    # 2b) the item-routed reuse flush
    rv, _ = distributed_uniwalk_simrank_reuse(
        sg, mesh1, UniWalkConfig(sample=2 * n, step=2, topk=4, reuse_times=2), key=1)
    done.append(f"{rv.shape} reuse top-k")
    # 2c) partitioned TopSim: owner exchange and routed increments
    tv, _ = distributed_topsim_simrank(sg, mesh1, TopSimConfig(sample=32.0, step=2, topk=4,
                                                               source_tile=2),
                                       key=2, sources=np.arange(4 * n, dtype=np.int32))
    done.append(f"{tv.shape} partitioned TopSim")
    # 2d) a two-window source sweep with the durable cursor (each rank
    # writes its own copy of the part files)
    wcfg = UniWalkConfig(sample=n, step=2, topk=4)
    with tempfile.TemporaryDirectory() as td:
        windowed_topk_sweep(lambda s, k: distributed_uniwalk_simrank(sg, mesh1, wcfg, key=k,
                                                                      sources=s),
                            n_sources=8 * n, out_dir=td, window=4 * n, key=3)
    done.append("2-window sweep")
    # 2e) second-order walks (plain and weighted) feeding data-parallel SGNS
    n2v = distributed_node2vec_walks(sg, 4 * n, 3, 0.5, 2.0, 4, mesh1)
    wg = build_graph(np.concatenate([edges, ring]), n_nodes=64, weights=np.concatenate(
        [rng.uniform(0.5, 2.0, len(edges)), np.ones(len(ring))]).astype(np.float32))
    distributed_node2vec_walks(shard_graph(wg, n, mesh=mesh1), 4 * n, 3, 2.0, 0.5, 5, mesh1,
                               weighted=True)
    syn0, _ = train_sgns_dp(gather_rows(n2v, mesh1.groups["data"]), 64, mesh1,
                            SGNSConfig(dim=16, window=2, negative=2, epochs=1, batch_size=32),
                            key=key_for(6))
    done.append(f"{(4 * n, 4)} node2vec walks (+weighted) into SGNS {syn0.shape}")

    # 3) dense sharded SimRank; 3b) the ring, f32 and bf16; 3c) SUMMA
    cfg2 = SimRankConfig(iterations=2)
    s = sharded_exact_simrank(g, mesh1, cfg2)
    s2 = sharded_simrank_spmm(g, mesh1, cfg2)
    s3 = sharded_simrank_spmm(g, mesh1, SimRankConfig(iterations=1), dtype=torch.bfloat16)
    r2 = max(1, n // 2)
    grid = (r2, 2) if n >= 2 and n % 2 == 0 else (n, 1)
    s4 = summa_simrank_spmm(g, make_2d_mesh(*grid, device=device), cfg2)
    for blk in (s, s2, s3, s4):
        if not bool(torch.isfinite(blk.values.float()).all()):
            raise RuntimeError("non-finite SimRank scores")
    done.append(f"dense {tuple(s.values.shape)}, ring {tuple(s2.values.shape)} (+bf16), "
                f"SUMMA {grid[0]}x{grid[1]} {tuple(s4.values.shape)} SimRank blocks")
    return f"{mesh.backend} on {dev}: " + ", ".join(done)


def main(argv=None) -> int:
    from graphtpu_torch.dist.mesh import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= args.n else "gloo"
    line = spawn(_rank, args.n, backend, args.device, args=(args.n,))
    print(f"dryrun({args.n}): {line} — OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
