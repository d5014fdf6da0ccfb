"""The ``.emb`` block writer against the per-value loop it replaced: the
same bytes on seeded values, with negatives, -0.0, ties at the last
decimal, magnitudes of 10 and more, rows the loop must take (not finite,
too large, not float32) and labels given as strings."""

import numpy as np
import pytest

from graphtpu_torch.io import embfile


def _loop_bytes(emb, labels=None, precision=6):
    """The writer before the block: one f-string a value."""
    emb = np.asarray(emb)
    n, d = emb.shape
    if labels is None:
        labels = [str(i) for i in range(n)]
    out = [f"{n} {d}\n"]
    for lab, row in zip(labels, emb):
        vals = " ".join(f"{x:.{precision}f}" for x in row)
        out.append(f"{lab} {vals}\n")
    return "".join(out).encode()


def _seeded(seed, n=200, d=16):
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(n, d)) * rng.choice([1e-4, 0.3, 3.0, 40.0, 2e4], size=(n, 1)))
    emb = emb.astype(np.float32)
    emb[0, :4] = [-0.0, 0.0, -1e-7, 5e-7]  # signs that round to zero
    # exact ties at the 7th decimal (odd multiples of 2**-7, 2**-8): rint
    # takes them to even, as Python does
    emb[1] = (2 * np.arange(d) + 1) / 128.0 * np.where(np.arange(d) % 2, -1, 1)
    emb[2] = (2 * np.arange(d) + 1) / 256.0 + 10.0
    emb[3] = np.float32(123456.5) + np.arange(d)  # magnitudes >= 10
    return emb


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3])
@pytest.mark.parametrize("labels", [None, "names"])
@pytest.mark.parametrize("precision", [6, 3, 0])
def test_block_bytes_equal_the_loop(tmp_path, seed, labels, precision):
    emb = _seeded(seed)
    labs = None if labels is None else [f"n{i * 7}" if i % 3 else str(i) for i in range(len(emb))]
    path = tmp_path / "a.emb"
    embfile.write_emb(str(path), emb, labels=labs, precision=precision)
    assert path.read_bytes() == _loop_bytes(emb, labs, precision)


def test_rows_the_block_cannot_prove_keep_the_loops_bytes(tmp_path):
    emb = _seeded(5, n=40, d=6)
    emb[3, 2] = np.nan
    emb[7, 0] = np.inf
    emb[8, 5] = -np.inf
    emb[20, 1] = 3e20  # past 2**53 once scaled
    emb[39, 4] = np.float32(1e10)
    labs = [f"node_{i}" for i in range(40)]
    path = tmp_path / "b.emb"
    embfile.write_emb(str(path), emb, labels=labs)
    assert path.read_bytes() == _loop_bytes(emb, labs)
    wide = emb.astype(np.float64) + 1e-9  # not float32: the loop for every row
    embfile.write_emb(str(path), wide, labels=labs)
    assert path.read_bytes() == _loop_bytes(wide, labs)


def test_read_back(tmp_path):
    emb = _seeded(9, n=30, d=5)
    labs = [str(i + 1) for i in range(30)]
    path = str(tmp_path / "c.emb")
    embfile.write_emb(path, emb, labels=labs)
    got_labels, got = embfile.read_emb(path)
    assert got_labels == labs
    # half the last decimal, and a float32 read of values past 1
    assert (np.abs(got - emb) <= 5e-7 + 6e-8 * np.abs(emb)).all()
