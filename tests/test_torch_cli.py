"""graphtpu_torch from scores to files: top-k tie order against
``lax.top_k``, the twin-file writer's bytes, the ``simrank`` CLI against
graphtpu's, and the package's independence from jax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.cli import main as j_main
from graphtpu.io.simfile import write_topk_files as j_write_topk_files
from graphtpu.kernels import topk as jtopk
from graphtpu.simrank.exact import exact_simrank as j_exact_simrank
from graphtpu_torch.cli import main as t_main
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.io.simfile import read_sim_file, read_topk_ids, write_topk_files
from graphtpu_torch.kernels import topk as ttopk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tied_scores(b=16, v=50, seed=0):
    """Rows drawn from four values: long runs of exact ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=(b, v)) / 4).astype(np.float32)


@pytest.mark.parametrize("k,offset", [(5, None), (20, None), (7, 3), (60, None)])
def test_topk_rows_tie_order_matches_lax(k, offset):
    x = _tied_scores()
    vals, idx = ttopk.topk_rows(torch.from_numpy(x), k, exclude_diag_offset=offset)
    jv, ji = jtopk.topk_rows(jnp.asarray(x), k, exclude_diag_offset=offset)
    assert idx.dtype == torch.int32 and vals.shape == (16, k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_topk_rows_bf16_matches_lax():
    x = _tied_scores(seed=1)
    vals, idx = ttopk.topk_rows(torch.from_numpy(x).bfloat16(), 9)
    jv, ji = jax.lax.top_k(jnp.asarray(x).astype(jnp.bfloat16), 9)
    assert vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(vals.float().numpy(), np.asarray(jv, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_merge_topk_matches_graphtpu():
    a, b = _tied_scores(seed=2), _tied_scores(seed=3)
    ta = ttopk.topk_rows(torch.from_numpy(a), 6)
    tb = ttopk.topk_rows(torch.from_numpy(b), 6)
    tb = (tb[0], tb[1] + 50)
    got = ttopk.merge_topk(*ta, *tb, 6)
    ja = jtopk.topk_rows(jnp.asarray(a), 6)
    jb = jtopk.topk_rows(jnp.asarray(b), 6)
    want = jtopk.merge_topk(*ja, jb[0], jb[1] + 50, 6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_write_topk_files_bytes_match(tmp_path):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 100, size=(12, 5)).astype(np.int32)
    idx[3, 2:] = -1  # padding entries are skipped
    vals = rng.random((12, 5)).astype(np.float32)
    a = write_topk_files(str(tmp_path / "t" / "out.txt"), idx, vals)
    b = j_write_topk_files(str(tmp_path / "j" / "out.txt"), idx, vals)
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.fixture()
def graph_file(tmp_path, small_random):
    rp = np.asarray(small_random.row_ptr)
    col = np.asarray(small_random.col)
    src = np.repeat(np.arange(small_random.n_nodes), np.diff(rp))
    keep = src < col
    path = str(tmp_path / "g.txt")
    write_edgelist(path, np.stack([src[keep], col[keep]], 1))
    return path


@pytest.mark.parametrize(
    "engine,extra",
    [("spmm", []), ("spmm", ["--relabel", "rcm"]), ("spmm", ["--mode", "fast"]),
     ("dense", [])],
)
def test_cli_matches_graphtpu(tmp_path, graph_file, small_random, engine, extra):
    common = ["simrank", "--input", graph_file, "--iterations", "3", "--topk",
              "10", "--engine", engine, *extra]
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    assert t_main(common + ["--output", out_t, "--device", "cpu"]) == 0
    assert j_main(common + ["--output", out_j]) == 0
    st, sj = read_sim_file(out_t + ".sim.txt"), read_sim_file(out_j + ".sim.txt")
    ids_t = read_topk_ids(out_t)
    assert set(st) == set(sj) == set(range(64))
    gold = np.asarray(j_exact_simrank(small_random))
    for r, pairs in sj.items():
        got = st[r]
        assert [n for n, _ in got] == ids_t[r]
        assert len(got) == len(pairs) == 10
        np.testing.assert_allclose([s for _, s in got], [s for _, s in pairs], atol=2e-5)
        for (nt, _), (nj, _) in zip(got, pairs):
            # ids must agree unless another column ties within the tolerance
            tied = np.sum(np.abs(gold[r] - gold[r, nj]) <= 4e-5) > 1
            assert tied or nt == nj, (r, nt, nj)


def test_cli_cuda_without_card_raises(tmp_path, graph_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["simrank", "--input", graph_file, "--output",
                str(tmp_path / "o.txt"), "--engine", "spmm"])
    assert not os.path.exists(str(tmp_path / "o.txt"))


def test_package_imports_neither_jax_nor_graphtpu():
    code = (
        "import sys\n"
        "import graphtpu_torch, graphtpu_torch.cli, graphtpu_torch.simrank.exact\n"
        "import graphtpu_torch.kernels.spmm, graphtpu_torch.kernels._build\n"
        "import graphtpu_torch.core.convert, graphtpu_torch.core.reorder\n"
        "import graphtpu_torch.bench.generators, graphtpu_torch.io.simfile\n"
        "import graphtpu_torch.pipelines, graphtpu_torch.walks.node2vec\n"
        "import graphtpu_torch.models.sgns, graphtpu_torch.eval.f1, graphtpu_torch.io.matfile\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'graphtpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
