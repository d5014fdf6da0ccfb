"""``python -m graphtpu_torch {deepsim,sdne,le,generate}`` on the CPU:
files written and read back, ``generate``'s files against graphtpu's, the
stage times printed, and the device subcommands' refusal without a card."""

import re

import numpy as np
import pytest
import torch

from graphtpu.cli import main as j_main
from graphtpu_torch.cli import main as t_main
from graphtpu_torch.io.edgelist import read_edgelist, write_edgelist
from graphtpu_torch.io.embfile import read_emb
from graphtpu_torch.pipelines_deepsim import load_walks

torch.set_num_threads(1)


@pytest.fixture
def graph_file(tmp_path):
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 64, (300, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    path = str(tmp_path / "g.txt")
    write_edgelist(path, edges)
    return path


def _stages(out):
    line = out.strip().splitlines()[-1]
    return {k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+) s", line)}


def test_cli_deepsim(tmp_path, graph_file, capsys):
    sr = str(tmp_path / "sr")
    assert t_main(["simrank", "--input", graph_file, "--output", sr, "--topk", "10",
                   "--engine", "spmm", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("(kernel launches: kahan 0, fast 0)")
    emb, cache = str(tmp_path / "d.emb"), str(tmp_path / "walks.txt")
    argv = ["deepsim", "--input", graph_file, "--simrank-path", sr + ".sim.txt",
            "--emb-output", emb, "--dimensions", "8", "--window-size", "3", "--steps", "20",
            "--walks-cache", cache, "--device", "cpu", "--vertex-num", "70"]
    assert t_main(argv) == 0
    assert list(_stages(capsys.readouterr().out)) == ["read", "walks", "train", "write"]
    labels, vecs = read_emb(emb)
    assert vecs.shape == (70, 8) and np.isfinite(vecs).all() and labels[69] == "69"
    assert load_walks(cache, 80).shape == (10 * 64, 80)
    assert t_main(argv) == 0  # reads the walks cache
    np.testing.assert_array_equal(read_emb(emb)[1], vecs)


def test_cli_sdne(tmp_path, graph_file, capsys):
    out = str(tmp_path / "sdne.emb")
    assert t_main(["sdne", "--input", graph_file, "--output", out, "--steps", "5",
                   "--hidden", "16", "8", "12", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("step ") == 5 and list(_stages(printed)) == ["read", "train", "write"]
    _, vecs = read_emb(out)
    assert vecs.shape == (64, 8) and np.isfinite(vecs).all()


def test_cli_le(tmp_path, graph_file, capsys):
    out = str(tmp_path / "le.npy")
    assert t_main(["le", "--output", out, "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    evals = [float(x) for x in line.split("eigenvalues ")[1].split(";")[0].split()]
    assert len(evals) == 2 and min(evals) > 1e-5
    assert list(_stages(line)) == ["embed", "eigh", "write"]
    y = np.load(out)
    assert y.shape == (2000, 2) and np.isfinite(y).all()
    sr = str(tmp_path / "sr")
    assert t_main(["simrank", "--input", graph_file, "--output", sr, "--iterations", "2",
                   "--topk", "5", "--device", "cpu"]) == 0
    le2 = str(tmp_path / "le2")
    assert t_main(["le", "--input", sr + ".sim.txt", "--output", le2, "--nodes", "64",
                   "--device", "cpu"]) == 0
    assert np.load(le2 + ".npy").shape == (64, 2)
    assert f"wrote {le2}.npy" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--kind", "uniform", "--nodes", "300", "--avg-degree", "6", "--seed", "2"],
    ["--kind", "bipartite", "--nodes", "200", "--right", "100", "--avg-degree", "4"],
    ["--kind", "directed", "--nodes", "150", "--avg-degree", "3", "--seed", "1"],
    ["--kind", "rmat", "--scale", "8", "--edges", "2000", "--seed", "1"],
])
def test_cli_generate_equals_graphtpu(tmp_path, argv):
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    assert t_main(["generate", "--output", a, *argv]) == 0
    assert j_main(["generate", "--output", b, *argv]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()


def test_cli_generate_massive(tmp_path, capsys):
    out = str(tmp_path / "massive.txt")
    assert t_main(["generate", "--output", out, "--kind", "massive", "--nodes", "1000",
                   "--right", "1000", "--avg-degree", "4"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}: 4000 edges"
    edges, _ = read_edgelist(out)
    assert len(np.unique(edges[:, 0] * 2000 + edges[:, 1])) == len(edges) == 4000
    assert edges[:, 0].max() < 1000 <= edges[:, 1].min() and edges[:, 1].max() < 2000


@pytest.mark.parametrize("cmd", [
    ["deepsim", "--simrank-path", "s.sim.txt", "--emb-output", "o.emb"],
    ["sdne", "--output", "o.emb"],
    ["le", "--output", "o.npy"],
])
def test_model_clis_without_card_raise(tmp_path, graph_file, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    before = sorted(p.name for p in tmp_path.iterdir())
    argv = cmd if cmd[0] == "le" else [cmd[0], "--input", graph_file, *cmd[1:]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == before
