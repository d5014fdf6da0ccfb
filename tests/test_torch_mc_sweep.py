"""graphtpu_torch's sweep layer against graphtpu's: precision and NDCG,
the windowed sweep's files and resume, the walk diagnostics, the sweep
functions, the ``uniwalk``/``topsim``/``sweep`` CLI, and the package's
independence from jax."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from graphtpu.bench import sweep as jsw
from graphtpu.bench import walkstats as jws
from graphtpu.cli import main as j_main
from graphtpu.dist.windows import windowed_topk_sweep as j_windowed
from graphtpu.eval import precision as jprec
from graphtpu.simrank.exact import exact_simrank as j_exact_simrank
from graphtpu_torch.bench import sweep as tsw
from graphtpu_torch.bench import walkstats as tws
from graphtpu_torch.cli import main as t_main
from graphtpu_torch.core.graph import graph_from_numpy
from graphtpu_torch.core.prng import key_for
from graphtpu_torch.dist.windows import read_sweep_results, windowed_topk_sweep
from graphtpu_torch.eval import precision as tprec
from graphtpu_torch.io.edgelist import write_edgelist
from graphtpu_torch.io.simfile import read_sim_file, read_topk_ids
from graphtpu_torch.utils import StepMetrics

torch.set_num_threads(1)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD_TOL = 2e-5   # the dense fp32 gold of the two packages (different matmul order)


def _port(jg):
    w = None if jg.weight is None else np.asarray(jg.weight)
    return graph_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col), w, np.asarray(jg.deg))


@pytest.fixture(scope="module")
def small(small_random):
    return small_random, _port(small_random)


@pytest.fixture(scope="module")
def gold_pair(small):
    jg, tg = small
    # top-10 golds: on 64 nodes a top-1000 gold holds every node, and any
    # approximation's precision against it is 1
    return (jsw.gold_standard(jg, iterations=10, k=10),
            tsw.gold_standard(tg, iterations=10, k=10, device=CPU))


GOLD = {0: [(1, 0.5), (2, 0.25), (3, 1e-10), (4, 0.125)], 1: [], 2: [(0, 0.3), (5, 0.3)],
        3: [(7, 0.9)]}
APPROX = {0: [(2, 0.4), (4, 0.2), (3, 0.1), (9, 0.05)], 2: [(5, 0.31), (6, 0.2)],
          3: [(7, 0.8), (1, 0.1)], 8: [(1, 0.5)]}


@pytest.mark.parametrize("k", [1, 2, 3, 20])
def test_precision_functions_equal(k):
    assert tprec.precision_sim_dicts(GOLD, APPROX, k=k) == jprec.precision_sim_dicts(GOLD, APPROX, k=k)
    assert tprec.ndcg_sim_dicts(GOLD, APPROX, k=k) == jprec.ndcg_sim_dicts(GOLD, APPROX, k=k)
    gi = {s: [i for i, _ in p] for s, p in GOLD.items()}
    ai = {s: [i for i, _ in p] for s, p in APPROX.items()}
    assert tprec.precision_at_k(gi, ai, k=k) == jprec.precision_at_k(gi, ai, k=k)


def test_precision_rules():
    # realK = min(k, |gold ids >= 1e-9|); realK 0 counts as 1.0
    assert tprec.precision_sim_dicts({0: [(1, 1e-10)]}, {}, k=5) == 1.0
    assert tprec.precision_sim_dicts({0: [(1, 0.5), (2, 0.5)]}, {0: [(2, 0.1)]}, k=5) == 0.5
    assert tprec.ndcg_sim_dicts({0: [(1, 1.0)]}, {0: [(2, 1.0)]}) == 1.0


def _fixed_tile(sources, key):
    """A deterministic tile: three neighbours per source, scores from ids."""
    s = np.asarray(sources, np.int64)
    idx = np.stack([(s + 1) % 50, (s + 7) % 50, (s + 13) % 50], 1).astype(np.int32)
    vals = (1.0 / (idx + s[:, None] + 2)).astype(np.float32)
    return vals, idx


def test_windows_resume_a_graphtpu_directory(tmp_path):
    """graphtpu writes the first window and stops; the port resumes from its
    cursor.  The part files are byte-equal to graphtpu's uninterrupted run
    and every source appears once."""
    calls = []

    def j_tile_stop(sources, key):
        if calls:
            raise KeyboardInterrupt
        calls.append(int(sources[0]))
        return _fixed_tile(sources, key)

    mixed, full = str(tmp_path / "mixed"), str(tmp_path / "full")
    with pytest.raises(KeyboardInterrupt):
        j_windowed(j_tile_stop, 50, mixed, window=20)
    seen = []

    def t_tile(sources, key):
        seen.append((int(sources[0]), key))
        return _fixed_tile(sources, key)

    metrics = StepMetrics()
    windowed_topk_sweep(t_tile, 50, mixed, window=20, key=9, metrics=metrics)
    assert seen == [(20, key_for(9, 20)), (40, key_for(9, 40))]
    assert [s["step"] for s in metrics.steps] == ["window[20:40]", "window[40:50]"]
    j_windowed(_fixed_tile, 50, full, window=20)
    assert sorted(os.listdir(mixed)) == sorted(os.listdir(full))
    for name in os.listdir(full):
        with open(os.path.join(mixed, name), "rb") as a, open(os.path.join(full, name), "rb") as b:
            assert a.read() == b.read(), name
    merged = read_sweep_results(mixed)
    assert sorted(merged) == list(range(50))
    # a finished directory runs no window again
    windowed_topk_sweep(t_tile, 50, mixed, window=20)
    assert len(seen) == 2


def test_walk_probabilities_match(small):
    jg, tg = small
    rng = np.random.default_rng(0)
    rp, col, _, deg = tg.host
    for _ in range(5):
        path = [int(rng.integers(64))]
        for _ in range(4):
            u = path[-1]
            path.append(int(col[rp[u] + rng.integers(deg[u])]))
        path = np.array(path)
        assert abs(tws.path_probability(tg, path) - jws.path_probability(jg, path)) <= 1e-9
        assert abs(tws.double_meet_probability(tg, path)
                   - jws.double_meet_probability(jg, path)) <= 1e-9
    with pytest.raises(ValueError):
        tws.double_meet_probability(tg, path[:4])


def test_walk_sampled_probabilities(small):
    """Monte-Carlo estimates within 5 standard errors of the exact values."""
    _, tg = small
    path = tws.random_path(tg, 3, 2, key=1, device=CPU)
    assert path[0] == 3 and len(path) == 3
    p = tws.path_probability(tg, path)
    n = 40000
    est = tws.sample_path_probability(tg, path, n, key=2, device=CPU)
    assert abs(est - p) <= 5 * np.sqrt(p * (1 - p) / n)
    q = tws.double_meet_probability(tg, path)
    est = tws.sample_double_meet_probability(tg, path, n, key=3, device=CPU)
    assert abs(est - q) <= 5 * np.sqrt(q * (1 - q) / n) + 1e-12


def test_pair_simrank_mc_parity(small):
    """The single-pair probe: both packages' means within 5 of their
    combined standard errors of each other."""
    jg, tg = small
    src, dst = 0, 1
    jm, js = jws.pair_simrank_mc(jg, src, dst, samples=4000, times=6)
    tm, ts = tws.pair_simrank_mc(tg, src, dst, samples=4000, times=6, device=CPU)
    assert tm > 0 and ts > 0
    assert abs(jm - tm) <= 5 * np.sqrt((js ** 2 + ts ** 2) / 6)
    with pytest.raises(ValueError):
        tws.pair_simrank_mc(tg, 2, 2, device=CPU)


def test_dict_helpers_equal():
    rng = np.random.default_rng(1)
    sim = (rng.integers(0, 5, size=(6, 12)) / 4).astype(np.float32)
    src = np.array([4, 0, 2], np.int32)
    assert tsw.sim_matrix_to_dict(sim, 4) == jsw.sim_matrix_to_dict(sim, 4)
    assert tsw.sim_matrix_to_dict(sim, 20) == jsw.sim_matrix_to_dict(sim, 20)
    assert tsw.sim_matrix_to_dict(sim[:3], 4, src) == jsw.sim_matrix_to_dict(sim[:3], 4, src)
    idx = np.array([[1, 2, -1], [0, 3, 5], [4, -1, -1]], np.int32)
    vals = np.array([[0.5, 0.2, 0], [0.4, 0.0, 0.1], [0.3, 0, 0]], np.float32)
    assert tsw.topk_to_dict(vals, idx, src) == jsw.topk_to_dict(vals, idx, src)


def test_gold_standard_matches(small, gold_pair):
    jg, _ = small
    jgold, tgold = gold_pair
    truth = np.asarray(j_exact_simrank(jg, jsw.SimRankConfig(iterations=10)))
    assert set(jgold) == set(tgold) == set(range(64))
    for s in jgold:
        assert len(jgold[s]) == len(tgold[s])
        np.testing.assert_allclose([v for _, v in tgold[s]], [v for _, v in jgold[s]],
                                   rtol=0, atol=GOLD_TOL)
        for (a, _), (b, _) in zip(tgold[s], jgold[s]):
            assert a == b or abs(truth[s, a] - truth[s, b]) <= GOLD_TOL
    sub = tsw.gold_standard(_port(jg), iterations=10, k=10, sources=np.array([5, 2]),
                            device=CPU)
    assert sub == {5: tgold[5], 2: tgold[2]}
    full = tsw.gold_standard(_port(jg), iterations=10, device=CPU)
    assert all(len(full[s]) == int((truth[s] > 0).sum()) for s in full)


@pytest.mark.parametrize("sweep,samples,kw", [
    ("sweep_uniwalk", (300, 3000), {}),
    ("sweep_topsim", (300.0,), {}),
    ("sweep_doublewalk", (50, 200), {}),
    ("sweep_doublesample", (10, 50), {}),
    ("sweep_topsim_dev", (2000.0,), {}),
    ("sweep_doublewalk", (20,), {"step": 2, "source_tile": 32}),
], ids=["uniwalk", "topsim", "doublewalk", "doublesample", "topsim_dev", "doublewalk_step2"])
def test_sweeps_parity(small, gold_pair, sweep, samples, kw):
    """Each sweep's precision within 0.05 of graphtpu's at each grid point,
    over a 24-source subset; NDCG within 0.05."""
    jg, tg = small
    jgold, tgold = gold_pair
    sources = np.arange(0, 64, 64 // 24, dtype=np.int32)[:24]
    j = getattr(jsw, sweep)(jg, jgold, samples=samples, topk=10, sources=sources, **kw)
    t = getattr(tsw, sweep)(tg, tgold, samples=samples, topk=10, sources=sources, device=CPU,
                             **kw)
    assert [r.sample for r in t] == list(samples)
    for a, b in zip(j, t):
        assert a.algorithm == b.algorithm
        assert abs(a.precision - b.precision) <= 0.05, (a, b)
        assert abs(a.ndcg - b.ndcg) <= 0.05, (a, b)


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    """A 40-node graph of degree <= 8 (step-2 enumeration fits), no
    isolated nodes."""
    rng = np.random.default_rng(11)
    edges = np.array([[i, (i + 1) % 40] for i in range(40)]
                     + [[int(a), int(b)] for a, b in rng.integers(0, 40, size=(30, 2)) if a != b])
    deg = np.bincount(np.concatenate([edges[:, 0], edges[:, 1]]), minlength=40)
    assert deg.max() <= 8
    path = str(tmp_path_factory.mktemp("mc") / "g.txt")
    write_edgelist(path, edges)
    return path


def _rows_ok(path, n, k):
    sims, ids = read_sim_file(path + ".sim.txt"), read_topk_ids(path)
    assert sorted(sims) == sorted(ids) == list(range(n))
    for s, pairs in sims.items():
        assert [i for i, _ in pairs] == ids[s] and len(pairs) <= k
        assert all(0 <= i < n and i != s for i, _ in pairs)
        scores = [v for _, v in pairs]
        assert scores == sorted(scores, reverse=True) and all(v > 0 for v in scores)
    return sims


def test_cli_topsim_enumerate_matches(tmp_path, edge_file):
    common = ["topsim", "--input", edge_file, "--step", "2", "--topk", "8",
              "--engine", "enumerate"]
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    assert t_main(common + ["--output", out_t, "--device", "cpu"]) == 0
    assert j_main(common + ["--output", out_j]) == 0
    st, sj = _rows_ok(out_t, 40, 8), _rows_ok(out_j, 40, 8)
    ones = read_sim_file(out_j + ".sim.txt")
    for s in sj:
        truth = dict(ones[s])
        assert len(st[s]) == len(sj[s])
        for (a, va), (b, vb) in zip(st[s], sj[s]):
            # scores to the printed precision (%.6f, half a unit each side)
            assert abs(va - vb) <= 1.01e-6, (s, a, b)
            assert a == b or abs(truth.get(a, va) - vb) <= 1.01e-6, (s, a, b)


def test_cli_uniwalk_and_sweep_write_what_graphtpu_does(tmp_path, edge_file, capsys):
    common = ["uniwalk", "--input", edge_file, "--sample", "600", "--step", "3", "--topk", "6"]
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    assert t_main(common + ["--output", out_t, "--device", "cpu", "--seed", "1"]) == 0
    printed = capsys.readouterr().out
    assert re.fullmatch(r"wrote \S+\(\.sim\.txt\) \(read [\d.]+ s, engine [\d.]+ s, "
                        r"write [\d.]+ s\)\n", printed), printed
    assert j_main(common + ["--output", out_j]) == 0
    st, sj = _rows_ok(out_t, 40, 6), _rows_ok(out_j, 40, 6)
    # both estimates rank alike: the two top-6 lists share 60% of their ids
    common_share = np.mean([len({i for i, _ in st[s]} & {i for i, _ in sj[s]})
                            / max(len(sj[s]), 1) for s in sj])
    assert common_share >= 0.6
    capsys.readouterr()
    lines = {}
    for name, main, extra in (("t", t_main, ["--device", "cpu"]), ("j", j_main, [])):
        assert main(["sweep", "--input", edge_file, "--log", str(tmp_path / f"{name}.log"),
                     "--algorithm", "topsim", "--samples", "100", "400", *extra]) == 0
        lines[name] = capsys.readouterr().out.strip().splitlines()
    pat = r"topsim_singleSample sample=(\d+): precision=([\d.]+) ndcg=([\d.]+) \([\d.]+s\)"
    for a, b in zip(lines["t"], lines["j"]):
        ma, mb = re.fullmatch(pat, a), re.fullmatch(pat, b)
        assert ma and mb and ma.group(1) == mb.group(1), (a, b)
        assert abs(float(ma.group(2)) - float(mb.group(2))) <= 0.05, (a, b)
    assert len(lines["t"]) == len(lines["j"]) == 2
    with open(tmp_path / "t.log") as f:
        assert len(f.read().splitlines()) == 2


def test_log_and_trace_profile(tmp_path, capsys):
    from graphtpu_torch.utils import Log, StopWatch, trace_profile

    with Log(str(tmp_path / "a.log")) as log:
        log.info("one")
        log.info("two")
    lines = (tmp_path / "a.log").read_text().splitlines()
    assert [ln.split("\t")[2] for ln in lines] == ["one", "two"]
    assert all(ln.split("\t")[1].startswith("DURATION ") for ln in lines)
    StopWatch.start()
    StopWatch.say("hi")
    assert capsys.readouterr().out.endswith("s] hi\n")
    with trace_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with trace_profile(None):
        pass
    m = StepMetrics()
    m.record("a", 1.5)
    with m.step("b", n=3) as rec:
        rec["extra"] = 1
    assert m.steps[1]["n"] == 3 and m.steps[1]["extra"] == 1
    assert m.bucket_histogram(1.0)[1] == 1 and m.total_seconds() >= 1.5


@pytest.mark.parametrize("cmd", [["uniwalk", "--output", "o.txt"],
                                 ["topsim", "--output", "o.txt"],
                                 ["sweep", "--log", "o.log"]])
def test_mc_cli_without_card_raises(tmp_path, edge_file, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main([cmd[0], "--input", edge_file, *cmd[1:]])
    assert not os.listdir(tmp_path)


def test_mc_modules_import_neither_jax_nor_graphtpu():
    code = (
        "import sys\n"
        "import graphtpu_torch.simrank, graphtpu_torch.simrank.uniwalk\n"
        "import graphtpu_torch.simrank.topsim, graphtpu_torch.simrank.doublewalk\n"
        "import graphtpu_torch.simrank.meeting, graphtpu_torch.bench.walkstats\n"
        "import graphtpu_torch.bench.sweep, graphtpu_torch.dist.windows, graphtpu_torch.utils\n"
        "import graphtpu_torch.eval.precision, graphtpu_torch.kernels.topk, graphtpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'graphtpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
