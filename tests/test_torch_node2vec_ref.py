"""graphtpu_torch's node2vec walks and SGNS against the benchmark's plain
reference (``benchmark/reference/node2vec.py``): the walks' hop kinds
against the bias rule at three (p, q), one SGNS step against the float64
step, a one-epoch run's edge-reconstruction AUC against the reference
trainer's on the same walks, and the path's counters and stage spans."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from benchmark.gen.graphs import kron
from benchmark.reference import node2vec as reference
from benchmark.runners.node2vec import _step_err
from graphtpu_torch import cli
from graphtpu_torch.core.config import SGNSConfig, WalkConfig
from graphtpu_torch.core.graph import build_graph
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.models import sgns
from graphtpu_torch.pipelines import node2vec_pipeline
from graphtpu_torch.walks import node2vec as n2v
from graphtpu_torch.walks.walker import simulate_walks

torch.set_num_threads(2)
CPU = torch.device("cpu")
# The walks' share of a hop kind is a mean over ~81,000 hops (its standard
# error under 2e-3), and a walker the rejection rounds never accept keeps
# its last proposal (at most 1e-3 of a hop's mass): the program reads
# 5.1e-4 to 1.2e-3 at these (p, q), first-order walks 0.115 to 0.221.
HOP_TOL = 0.01
# Float32 against float64: the new table values are rounded once to
# float32, half an ulp of a value of ~0.1 against a change of ~1e-4 to
# 1e-3, a few 1e-5 of a row's scale (2.7e-5 to 3.8e-5 over six seeds; the
# gradients' own float32 sums are 1e-7 of it); gradients rounded to
# bfloat16 read 3.1e-3 to 3.8e-3.
STEP_TOL = 2e-4
# Two trainers of one law on the same walks, each from its own draws,
# over 20,000 edges and as many pairs: the gap reads 6e-4 and 3.3e-3 on
# these seeds, a run on a tenth of the walks 0.36.
AUC_TOL = 0.05


def _kron(seed, scale=8):
    e = kron(seed, scale, 26, [0.57, 0.19, 0.19, 0.05])
    return e, int(e.max()) + 1


@pytest.mark.parametrize("p,q", [(0.25, 0.25), (1.0, 2.0), (4.0, 0.5)])
def test_hop_kinds_follow_the_bias_rule(p, q):
    edges, n = _kron(3)
    g = build_graph(edges, n_nodes=n)
    adj = reference.adjacency(edges, n, CPU)
    walks = simulate_walks(g, 12, 30, 21, p=p, q=q, device=CPU)
    assert reference.walk_faults(walks, adj, 12) == {"bad_hops": 0.0, "bad_starts": 0.0}
    got, want = reference.hop_shares(walks, adj, p, q)
    assert float((got - want).abs().max()) < HOP_TOL, (got, want)
    assert float(got.sum()) == pytest.approx(1.0) and float(want.sum()) == pytest.approx(1.0)
    # first-order walks are not what the rule gives at this (p, q)
    uniform = simulate_walks(g, 12, 30, 21, device=CPU)
    got, want = reference.hop_shares(uniform, adj, p, q)
    assert float((got - want).abs().max()) > 2 * HOP_TOL


def test_walk_faults_count_what_is_wrong():
    edges, n = _kron(3)
    adj = reference.adjacency(edges, n, CPU)
    walks = simulate_walks(build_graph(edges, n_nodes=n), 2, 10, 5, p=0.5, q=2.0, device=CPU)
    bad = walks.clone()
    a, b = np.argwhere(adj.numpy() == 0)[0]
    bad[0, 3], bad[0, 4] = int(a), int(b)  # a hop that is no edge (and two more around it)
    bad[1, 5:] = -1  # a walk cut short where its node has neighbours
    faults = reference.walk_faults(bad, adj, 2)
    assert faults["bad_hops"] >= 2 and faults["bad_starts"] == 0
    assert reference.walk_faults(walks[:-1], adj, 2)["bad_starts"] == 1


def _step_inputs(seed, n=40, d=16, b=64, w=3, negative=5):
    gen = torch.Generator().manual_seed(seed)
    syn0 = (torch.rand((n, d), generator=gen) - 0.5) / d
    syn1 = torch.randn((n, d), generator=gen) * 0.1
    centers = torch.randint(-1, n, (b,), generator=gen)
    contexts = torch.randint(-1, n, (b, 2 * w), generator=gen)
    contexts[:4, 0] = centers[:4]  # a context that is its center
    mask = (torch.rand((b, 2 * w), generator=gen) < 0.8) & (contexts >= 0)
    negs = torch.randint(0, n, (b, negative), generator=gen, dtype=torch.int32)
    negs[:5, 0] = contexts[:5, 1].clamp(min=0).int()  # negatives that hit the context
    negs[5:9, 1] = centers[5:9].clamp(min=0).int()    # and the center
    return (syn0, syn1), centers, contexts, mask, negs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sgns_step_is_the_float64_step(seed):
    params, centers, contexts, mask, negs = _step_inputs(seed)
    out = sgns.sgns_step(params, centers, contexts, mask, negs, 0.025, 40)
    record = {"params": params, "centers": centers, "contexts": contexts, "mask": mask,
              "negs": negs, "lr": 0.025, "out": out}
    assert _step_err(record, CPU) < STEP_TOL
    rounded = sgns.sgns_manual_grads(params, centers, contexts, mask, negs, 40)
    (g0, g1), (c0, c1) = rounded
    bf16 = (params[0] - 0.025 * (g0.bfloat16().float() / c0.clamp(min=1)[:, None]),
            params[1] - 0.025 * (g1.bfloat16().float() / c1.clamp(min=1)[:, None]))
    assert _step_err(dict(record, out=bf16), CPU) > 10 * STEP_TOL
    assert _step_err(None, CPU) == float("inf")


@pytest.mark.parametrize("seed", [1, 2])
def test_one_epoch_auc_is_the_reference_trainers(seed):
    edges, n = _kron(seed, scale=9)
    g = build_graph(edges, n_nodes=n)
    adj = reference.adjacency(edges, n, CPU)
    walks = simulate_walks(g, 10, 40, seed, p=0.25, q=0.25, device=CPU)
    cfg = SGNSConfig(dim=16, window=5, epochs=1)
    batch = min(cfg.batch_size, walks.numel(), max(64, n))
    pos, neg = reference.auc_pairs(adj, 20_000, seed)
    ref = reference.train_epochs(walks, n, 16, 5, 5, 1e-3, cfg.alpha, cfg.min_alpha, batch, 1,
                                 seed)
    got = torch.as_tensor(sgns.train_sgns(walks, n, cfg, key=seed, device=CPU)[0])
    gap = abs(reference.edge_auc(ref, pos, neg) - reference.edge_auc(got, pos, neg))
    assert gap < AUC_TOL
    tenth = torch.as_tensor(sgns.train_sgns(walks[: len(walks) // 10], n, cfg, key=seed,
                                            device=CPU)[0])
    assert abs(reference.edge_auc(ref, pos, neg) - reference.edge_auc(tenth, pos, neg)) > 2 * AUC_TOL


def test_edge_auc_ranks_ties_half():
    emb = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    pos = torch.tensor([[0, 1], [0, 2]])  # scores 1, 0
    neg = torch.tensor([[2, 3], [1, 2]])  # scores 0, 0
    assert reference.edge_auc(emb, pos, neg) == pytest.approx((1.0 + 0.5) / 2)


def test_counters_and_stage_spans_of_a_job(tmp_path):
    edges, n = _kron(4)
    path = str(tmp_path / "g.txt")
    write_edgelist(path, edges)
    before = dict(n2v.NODE2VEC_COUNTS), dict(sgns.SGNS_COUNTS)
    out, prof = str(tmp_path / "g.emb"), str(tmp_path / "prof")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["node2vec", "--input", path, "--output", out, "--p", "0.25", "--q",
                         "0.25", "--num-walks", "2", "--walk-length", "12", "--iter", "1",
                         "--dimensions", "8", "--window-size", "3", "--device", "cpu",
                         "--profile", prof]) == 0
    line = buf.getvalue().strip()
    assert line.startswith(f"wrote {out} (read ") and line.endswith(" s)")
    assert [part.split()[0] for part in line[line.index("(") + 1:-1].split(", ")] == [
        "read", "walks", "sgns", "write"]
    assert "traceEvents" in json.loads((tmp_path / "prof" / "trace.json").read_text())
    walked = {k: n2v.NODE2VEC_COUNTS[k] - before[0][k] for k in before[0]}
    stepped = {k: sgns.SGNS_COUNTS[k] - before[1][k] for k in before[1]}
    active = len(np.unique(edges))
    assert walked["walks"] == 2 * active and walked["hops"] == 2 * active * 11
    # p = q = 0.25: panels of 8 in rounds of up to 3, one proposal a walker first
    assert 2 * active * (1 + 10 * 8) <= walked["proposals"] <= 2 * active * (1 + 10 * 24)
    assert walked["host_reads"] <= 10 * 2
    batch = min(8192, 2 * active * 12, max(64, n))
    assert stepped["steps"] == 2 * active * 12 // batch
    assert stepped["centers"] == stepped["steps"] * batch
    assert stepped["negatives"] == stepped["centers"] * 5
    assert 0 < stepped["pairs"] <= stepped["centers"] * 6
    times = {}
    node2vec_pipeline(build_graph(edges, n_nodes=n), WalkConfig(num_walks=1, walk_length=6),
                      SGNSConfig(dim=8, window=2, epochs=1), output=str(tmp_path / "h.emb"),
                      device="cpu", stage_times=times)
    assert list(times) == ["walks", "sgns", "write"] and min(times.values()) > 0
