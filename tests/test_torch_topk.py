"""graphtpu_torch's row top-k (``kernels/topk.py``) on the CPU: the checks
that the CUDA kernel's wrapper makes before any launch, the plain path a
CPU tensor takes (no launch; the results of ``lax.top_k``), and the order
that the kernel is held to on the card (``tests/test_torch_topk_cuda.py``):
the radix sort's key, -0.0 as +0.0, ties by column, which the plain
version's stable sort gives here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.kernels import topk as jtopk
from graphtpu_torch.kernels import topk

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["float64", "float16", "int32", "non-contiguous", "3-d",
                                  "k-1025", "diag-negative", "diag-past-end"])
def test_kernel_args_rejected_before_any_launch(case):
    x, k, diag, err, says = {
        "float64": (torch.zeros(4, 8, dtype=torch.float64), 2, None, TypeError, "float32"),
        "float16": (torch.zeros(4, 8, dtype=torch.float16), 2, None, TypeError, "float32"),
        "int32": (torch.zeros(4, 8, dtype=torch.int32), 2, None, TypeError, "float32"),
        "non-contiguous": (torch.zeros(8, 4).t(), 2, None, ValueError, "contiguous"),
        "3-d": (torch.zeros(2, 3, 4), 2, None, ValueError, "2-D"),
        "k-1025": (torch.zeros(2, 2000), 1025, None, ValueError, "1024"),
        "diag-negative": (torch.zeros(4, 8), 2, -1, ValueError, "leave"),
        "diag-past-end": (torch.zeros(4, 8), 2, 5, ValueError, "leave"),
    }[case]
    before = dict(topk.TOPK_LAUNCHES)
    with pytest.raises(err, match=says):
        topk.check_topk_args(x, k, diag)
    assert topk.TOPK_LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,diag", [((4, 2000), 1024, None), ((3, 100), 5000, None),
                                          ((4, 8), 2, 4), ((0, 8), 3, 7), ((5, 1), 1, None)])
def test_kernel_args_accepted(shape, k, diag, dtype):
    topk.check_topk_args(torch.zeros(shape, dtype=dtype), k, diag)


def _tied_scores(b=16, v=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=(b, v)) / 4).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("k,diag", [(1, None), (20, None), (50, None), (7, 3), (80, None)])
def test_cpu_takes_the_plain_path(k, diag, dtype):
    """No launch on the CPU, every dtype the plain version takes (float64
    too), and the results of graphtpu's ``lax.top_k``."""
    x = _tied_scores(seed=k)
    before = dict(topk.TOPK_LAUNCHES)
    vals, idx = topk.topk_rows(torch.from_numpy(x).to(dtype), k, exclude_diag_offset=diag)
    assert topk.TOPK_LAUNCHES == before
    jx = jnp.asarray(x).astype({torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                                torch.float64: jnp.float32}[dtype])
    jv, ji = jtopk.topk_rows(jx, k, exclude_diag_offset=diag)
    assert vals.dtype == dtype and idx.dtype == torch.int32 and vals.shape == (16, k)
    np.testing.assert_array_equal(vals.float().numpy(), np.asarray(jv, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_stable_topk_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(_tied_scores(b=40, v=300, seed=5))
    before = dict(topk.TOPK_LAUNCHES)
    got = topk._stable_topk(x, 30)
    want = topk.stable_topk_plain(x, 30)
    assert topk.TOPK_LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64
    sv, si = torch.sort(x, dim=1, descending=True, stable=True)
    assert torch.equal(got[0], sv[:, :30]) and torch.equal(got[1], si[:, :30])


def _radix_keys(x: torch.Tensor) -> np.ndarray:
    """The kernel's order-preserving key of each element: the sign bit
    flipped where clear, every bit where set; -0.0 as +0.0."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32).numpy().view(np.uint32).astype(np.uint64)
        sign, full = 0x80000000, 0xFFFFFFFF
    else:
        b = x.view(torch.int16).numpy().view(np.uint16).astype(np.uint64)
        sign, full = 0x8000, 0xFFFF
    b = np.where(b == sign, 0, b)
    return np.where(b & sign, ~b & full, b | sign)


# +NaN (the sign bit clear): the contract's NaN.  A NaN with its sign bit
# set has the least key, but a comparison sort puts every NaN first.
_POS_NAN = {torch.float32: torch.tensor(0x7FC00000, dtype=torch.int32).view(torch.float32),
            torch.bfloat16: torch.tensor(0x7FC0, dtype=torch.int16).view(torch.bfloat16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 9, 300, 5000])
def test_plain_order_is_the_kernels_key_order(n, dtype):
    """Rows of +-0.0, +-inf, +NaN, +-1 and ties: the plain version's first k
    are the k greatest keys, equal keys by column, so the CPU and the card
    give one answer."""
    rng = np.random.default_rng(n)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5], np.float32)
    x = torch.from_numpy(rng.choice(pool, size=(6, n))).to(dtype)
    x[torch.isnan(x)] = _POS_NAN[dtype]  # a cast may set a NaN's sign bit
    k = min(n, 40)
    vals, idx = topk.stable_topk_plain(x, k)
    keys = _radix_keys(x)
    for r in range(x.shape[0]):
        want = sorted(range(n), key=lambda i: (-int(keys[r, i]), i))[:k]
        np.testing.assert_array_equal(idx[r].numpy(), want)
        np.testing.assert_array_equal(_radix_keys(vals[r:r + 1])[0], keys[r, want])


def test_topk_rows_bf16_ties_match_lax():
    x = _tied_scores(seed=11)
    vals, idx = topk.topk_rows(torch.from_numpy(x).bfloat16(), 60)
    jv, ji = jax.lax.top_k(jnp.asarray(x).astype(jnp.bfloat16), 50)
    np.testing.assert_array_equal(idx[:, :50].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals[:, :50].float().numpy(), np.asarray(jv, np.float32))
    assert (idx[:, 50:] == -1).all() and (vals[:, 50:] == 0).all()
