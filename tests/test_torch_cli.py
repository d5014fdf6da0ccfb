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
from graphtpu_torch.io import simfile
from graphtpu_torch.io.simfile import (
    read_sim_file,
    read_topk_ids,
    write_sim_file,
    write_topk_files,
)
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


def _old_topk_files(out_path, indices, scores, sources=None, precision=6, separator=","):
    """The writer as a loop over entries: the bytes every path must give."""
    n = indices.shape[0]
    srcs = np.arange(n) if sources is None else np.asarray(sources)
    with open(out_path, "w") as fid, open(out_path + ".sim.txt", "w") as fsim:
        for i in range(n):
            idparts, simparts = [str(int(srcs[i]))], [str(int(srcs[i]))]
            for j in range(indices.shape[1]):
                idx = int(indices[i, j])
                if idx < 0:
                    continue
                idparts.append(str(idx))
                simparts.append(f"{idx}:{float(scores[i, j]):.{precision}f}")
            fid.write(separator.join(idparts) + "\n")
            fsim.write(separator.join(simparts) + "\n")
    return out_path, out_path + ".sim.txt"


def _old_sim_file(path, indices, scores, precision=6, kv_separator=":", min_score=None):
    with open(path, "w") as f:
        for i in range(indices.shape[0]):
            parts = [str(i)]
            for j in range(indices.shape[1]):
                idx = int(indices[i, j])
                if idx < 0:
                    continue
                sc = float(scores[i, j])
                if min_score is not None and sc < min_score:
                    continue
                parts.append(f"{idx}{kv_separator}{sc:.{precision}f}")
            f.write(",".join(parts) + "\n")


def _random_case():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 100, size=(12, 5)).astype(np.int32)
    idx[3, 2:] = -1  # padding entries are skipped
    return idx, rng.random((12, 5)).astype(np.float32), {}


_F32 = np.float32
# exact halves round to even (1/128 -> 0.007812, 3/128 -> 0.023438); 5e-7
# and its float32 neighbours straddle the last digit
_HARD_SCORES = [1 / 128, 3 / 128, 5 / 128, 0.0, 1.0, 0.9999995, 0.5, 12.5, 65504.0,
                float(_F32(5e-7)), float(np.nextafter(_F32(5e-7), _F32(0))),
                float(np.nextafter(_F32(5e-7), _F32(1))), 1.5e-6, 2.5e-6, 0.1234565]


def _scores_case():
    v = np.array(_HARD_SCORES, np.float32)
    return np.arange(v.size, dtype=np.int32).reshape(3, 5), v.reshape(3, 5), {}


def _ids_case():
    idx = np.array([[0, 7, 42, 99, 100], [999, 1000, 9999, 99999, 123456],
                    [1234567, 98765432, 123456789, 1000000000, 2 ** 31 - 1]], np.int64)
    return idx, np.full(idx.shape, 0.25, np.float32), {}


def _padding_case():
    idx, vals, _ = _random_case()
    idx[1, 2] = -1       # in the middle of a row
    idx[2, 4] = -1       # at its end
    idx[5, :] = -1       # the whole row
    vals[5, 0] = np.nan  # a padding entry's score is never read
    return idx, vals, {}


def _sources_case():
    idx, vals, _ = _random_case()
    return idx, vals, {"sources": np.array([5, 0, 123456789, 77, 2 ** 31 - 1, 3, 10, 11, 9,
                                            1000, 4, 8], np.int64)}


def _fallback_case():
    idx, vals, _ = _random_case()
    vals[2, 0], vals[4, 3], vals[6, 1] = np.nan, np.inf, -np.inf
    vals[7, 2], vals[8, 4], vals[9, 0] = -0.25, -0.0, -1e-9  # signs: -0.000000
    return idx, vals, {}


@pytest.mark.parametrize("case,rows", [
    (_random_case, (12, 0)),
    (_scores_case, (3, 0)),
    (_ids_case, (3, 0)),
    (_padding_case, (12, 0)),
    (_sources_case, (12, 0)),
    (lambda: (*_random_case()[:2], {"precision": 7}), (12, 0)),
    # 65504 * 10**12 is past 2**53: its row takes the loop
    (lambda: (*_scores_case()[:2], {"precision": 12}), (2, 1)),
    (lambda: (_random_case()[0][:, :1], _random_case()[1][:, :1], {}), (12, 0)),  # k = 1
    (lambda: (np.zeros((0, 20), np.int32), np.zeros((0, 20), np.float32), {}), (0, 0)),
    (lambda: (_random_case()[0], _random_case()[1].astype(np.float64), {}), (0, 12)),
    (lambda: (*_scores_case()[:2], {"precision": 13}), (0, 3)),
    (_fallback_case, (6, 6)),
], ids=["random", "scores", "ids", "padding", "sources", "precision7", "precision12",
        "k1", "empty", "float64", "precision13", "nonfinite_negative"])
def test_write_topk_files_bytes_match(tmp_path, case, rows):
    """Every path of the writer gives graphtpu's bytes and the loop's; the
    counter says which path each row took (array, python)."""
    idx, vals, kw = case()
    before = dict(simfile.WRITE_ROWS)
    a = write_topk_files(str(tmp_path / "t" / "out.txt"), idx, vals, **kw)
    assert tuple(simfile.WRITE_ROWS[k] - before[k] for k in ("array", "python")) == rows
    b = j_write_topk_files(str(tmp_path / "j" / "out.txt"), idx, vals, **kw)
    c = _old_topk_files(str(tmp_path / "old.txt"), idx, vals, **kw)
    for pa, pb, pc in zip(a, b, c):
        with open(pa, "rb") as fa, open(pb, "rb") as fb, open(pc, "rb") as fc:
            got = fa.read()
            assert got == fb.read()
            assert got == fc.read()


@pytest.mark.parametrize("kw", [{}, {"min_score": 0.5}, {"min_score": 0.5, "precision": 7,
                                                         "kv_separator": "="}])
@pytest.mark.parametrize("case", [_random_case, _padding_case, _fallback_case])
def test_write_sim_file_bytes_match(tmp_path, case, kw):
    idx, vals, _ = case()
    write_sim_file(str(tmp_path / "t.sim.txt"), idx, vals, **kw)
    _old_sim_file(str(tmp_path / "old.sim.txt"), idx, vals, **kw)
    assert (tmp_path / "t.sim.txt").read_bytes() == (tmp_path / "old.sim.txt").read_bytes()


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


def test_cli_formats_every_row_with_array_passes(tmp_path, graph_file, capsys):
    argv = ["simrank", "--input", graph_file, "--iterations", "3", "--topk", "10",
            "--engine", "spmm", "--output", str(tmp_path / "o.txt"), "--device", "cpu"]
    assert t_main(argv) == 0
    assert "; rows written: array 64, python 0) (kernel launches:" in capsys.readouterr().out


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
