"""graphtpu_torch's embedding path end to end against graphtpu's: the
``.emb`` writer's bytes, the TopKRanker scoring, the ``node2vec`` CLI, and
the slice as a whole, held to graphtpu's micro-F1 on a planted partition."""

import os

import jax
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import graphtpu
from graphtpu.core.config import SGNSConfig as JSGNSConfig
from graphtpu.core.config import WalkConfig as JWalkConfig
from graphtpu.eval import f1 as jf1
from graphtpu.io import embfile as jemb
from graphtpu.pipelines import node2vec_pipeline as j_node2vec_pipeline
from graphtpu_torch import build_graph
from graphtpu_torch.cli import main as t_main
from graphtpu_torch.core.config import SGNSConfig, WalkConfig
from graphtpu_torch.eval import f1 as tf1
from graphtpu_torch.io import embfile as temb
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.io.matfile import labels_to_lists
from graphtpu_torch.pipelines import node2vec_pipeline

torch.set_num_threads(1)
F1_MARGIN = 0.08  # the port's mean micro-F1 may trail graphtpu's by this much


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_write_emb_bytes_match_and_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    emb = (rng.normal(size=(9, 5)) * 3).astype(np.float32)
    emb[2, 1] = -0.0
    labels = ["a", "7", "node_3", "x", "y", "z", "11", "12", "13"]
    for labs in (None, labels):
        a, b = str(tmp_path / "t.emb"), str(tmp_path / "j.emb")
        temb.write_emb(a, emb, labels=labs)
        jemb.write_emb(b, emb, labels=labs)
        assert _read(a) == _read(b)
    tl, tv = temb.read_emb(str(tmp_path / "j.emb"))
    jl, jv = jemb.read_emb(str(tmp_path / "t.emb"))
    assert tl == jl == labels
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tv, emb, atol=5e-7)


def test_topk_ranker_scoring_and_emb_file_scoring_match(tmp_path):
    rng = np.random.default_rng(1)
    n, c = 60, 3
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = [[int(x)] for x in rng.integers(0, c, n)]
    labels[4].append((labels[4][0] + 1) % c)
    kw = dict(train_fractions=[0.3, 0.7], n_shuffles=2, seed=3)
    assert tf1.topk_ranker_scoring(feats, labels, c, **kw) == jf1.topk_ranker_scoring(
        feats, labels, c, **kw)
    # the reference scoring() flow: a .emb labelled 1..N and a .mat
    group = sp.lil_matrix((n, c))
    for i, labs in enumerate(labels):
        for l in labs:
            group[i, l] = 1
    mat = str(tmp_path / "g.mat")
    scipy.io.savemat(mat, {"network": sp.csc_matrix((n, n)), "group": group.tocsc()})
    emb = str(tmp_path / "e.emb")
    temb.write_emb(emb, feats, labels=[str(i + 1) for i in range(n)])
    assert labels_to_lists(group.tocsc()) == [sorted(l) for l in labels]
    assert tf1.scoring_from_emb_file(emb, mat, **kw) == jf1.scoring_from_emb_file(emb, mat, **kw)


@pytest.fixture(scope="module")
def karate_file(tmp_path_factory):
    """The karate club edge list with the reference file's ids 1..34."""
    import networkx as nx

    path = str(tmp_path_factory.mktemp("karate") / "karate.edgelist")
    write_edgelist(path, np.array(nx.karate_club_graph().edges()) + 1)
    return path


SMALL = ["--dimensions", "8", "--walk-length", "10", "--num-walks", "2", "--iter", "1",
         "--window-size", "3"]


def test_cli_node2vec_writes_reference_format(tmp_path, karate_file):
    out = str(tmp_path / "k.emb")
    assert t_main(["node2vec", "--input", karate_file, "--output", out, "--p", "1", "--q",
                   "2", "--device", "cpu", *SMALL]) == 0
    labels, vecs = temb.read_emb(out)
    assert vecs.shape == (34, 8) and np.isfinite(vecs).all()
    assert sorted(labels, key=int) == [str(i) for i in range(1, 35)]  # 0 is isolated


def test_cli_node2vec_grid_and_directed(tmp_path, karate_file):
    out = str(tmp_path / "g.emb")
    assert t_main(["node2vec", "--input", karate_file, "--output", out, "--grid", "1,2",
                   "--device", "cpu", *SMALL]) == 0
    for p in ("1", "2"):
        for q in ("1", "2"):
            assert temb.read_emb(f"{out}.p{p}_q{q}.emb")[1].shape == (34, 8)
    assert len(os.listdir(tmp_path)) == 4
    diag = str(tmp_path / "d.emb")
    assert t_main(["node2vec", "--input", karate_file, "--output", diag, "--grid", "1,2",
                   "--grid-diag", "--device", "cpu", *SMALL]) == 0
    assert sorted(os.listdir(tmp_path))[:2] == ["d.emb.p1_q1.emb", "d.emb.p2_q2.emb"]
    directed = str(tmp_path / "dir.emb")
    assert t_main(["node2vec", "--input", karate_file, "--output", directed, "--directed",
                   "--device", "cpu", *SMALL]) == 0
    # out-edges go from lower to higher id: node 34 has none, so it is left out
    labels, _ = temb.read_emb(directed)
    assert "34" not in labels and "1" in labels


def test_cli_node2vec_without_card_raises(tmp_path, karate_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.emb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["node2vec", "--input", karate_file, "--output", out, *SMALL])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node2vec_pipeline(build_graph(np.array([[0, 1]])), output=out)
    assert not os.path.exists(out)


def _planted_partition():
    """4 blocks x 32 nodes, p_in 0.15, p_out 0.03: 477 edges at seed 0."""
    rng = np.random.default_rng(0)
    n = 128
    block = np.repeat(np.arange(4), 32)
    iu, ju = np.triu_indices(n, 1)
    prob = np.where(block[iu] == block[ju], 0.15, 0.03)
    keep = rng.random(len(iu)) < prob
    return np.stack([iu[keep], ju[keep]], 1), block


def test_slice_f1_matches_graphtpu(tmp_path):
    """The whole slice: walks (p=1, q=2), SGNS, .emb, TopKRanker F1 on a
    planted partition; the port's mean micro-F1 is graphtpu's less at most
    F1_MARGIN, with the same graph, settings and seed."""
    edges, block = _planted_partition()
    assert len(edges) == 477
    labels = [[int(b)] for b in block]
    walk = dict(num_walks=10, walk_length=20, p=1.0, q=2.0)
    sgns = dict(dim=16, window=5, epochs=10, batch_size=64, subsample=0)
    jemb_ = j_node2vec_pipeline(graphtpu.build_graph(edges, n_nodes=128), JWalkConfig(**walk),
                                JSGNSConfig(**sgns), seed=0)
    out = str(tmp_path / "pp.emb")
    temb_ = node2vec_pipeline(build_graph(edges, n_nodes=128), WalkConfig(**walk),
                              SGNSConfig(**sgns), seed=0, output=out, device="cpu")
    assert temb_.shape == (128, 16) and np.isfinite(temb_).all()
    kw = dict(train_fractions=[0.5], n_shuffles=3, seed=0)
    micro = {}
    for name, emb in (("graphtpu", np.asarray(jemb_)), ("port", temb_)):
        res = tf1.topk_ranker_scoring(emb, labels, 4, **kw)[0.5]
        micro[name] = float(np.mean([r["micro"] for r in res]))
    assert micro["port"] >= micro["graphtpu"] - F1_MARGIN, micro
    # the written file holds the same rows
    labs, vecs = temb.read_emb(out)
    np.testing.assert_allclose(vecs, temb_[[int(l) for l in labs]], atol=5e-7)
