"""graphtpu_torch's 2-D transpose (``kernels/transpose.py``) on the CPU:
the wrapper against ``x.t().contiguous()``, its input checks, and the
transpose stage of ``exact_simrank_spmm`` (both branches) through it,
against graphtpu.  Its CUDA kernel is tested on the card in
``tests/test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.core.config import SimRankConfig as JConfig
from graphtpu.core.graph import host_csr
from graphtpu.simrank import exact as jexact
from graphtpu_torch.core.config import SimRankConfig
from graphtpu_torch.core.convert import graph_from_numpy
from graphtpu_torch.kernels import transpose
from graphtpu_torch.simrank import exact as texact

torch.set_num_threads(1)

SHAPES = [(1, 300), (300, 1), (33, 65), (257, 4097), (64, 64), (96, 200)]


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_equals_plain_on_cpu(shape, dtype):
    x = _x(shape, dtype)
    before = dict(transpose.TRANSPOSE_LAUNCHES)
    got = transpose.transpose_2d(x)
    assert got.shape == (shape[1], shape[0]) and got.dtype == dtype
    assert got.is_contiguous()
    assert torch.equal(got, x.t().contiguous())
    assert transpose.TRANSPOSE_LAUNCHES == before  # no kernel on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_the_products_first_v_rows(dtype):
    """The stream branch's ``ps[:v]`` of a [V+1, V] product: a contiguous
    slice, transposed without a copy to get it."""
    v = 130
    ps = _x((v + 1, v), dtype, seed=1)
    head = ps[:v]
    assert head.is_contiguous() and head.data_ptr() == ps.data_ptr()
    assert torch.equal(transpose.transpose_2d(head), ps[:v].t().contiguous())


@pytest.mark.parametrize("case", ["3-d", "non-contiguous", "float64", "int32", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, err = {
        "3-d": (torch.zeros(2, 3, 4), ValueError),
        "non-contiguous": (torch.zeros(6, 8)[:, ::2], ValueError),
        "float64": (torch.zeros(4, 4, dtype=torch.float64), TypeError),
        "int32": (torch.zeros(4, 4, dtype=torch.int32), TypeError),
        "meta": (torch.empty(4, 4, device="meta"), RuntimeError),
    }[case]
    with pytest.raises(err):
        transpose.transpose_2d(x)


def _to_torch(jg):
    return graph_from_numpy(*(None if a is None else np.asarray(a) for a in host_csr(jg)))


@pytest.mark.parametrize("impl", ["stream", "tree"])
def test_simrank_spmm_transposes_through_the_wrapper(small_random, impl, monkeypatch):
    """Each iteration's transpose stage goes through ``transpose_2d``, and
    the scores on the CPU stay those of graphtpu's branch."""
    calls = []

    def counted(x):
        calls.append(tuple(x.shape))
        return transpose.transpose_2d(x)

    monkeypatch.setattr(texact, "transpose_2d", counted)
    g = _to_torch(small_random)
    got = texact.exact_simrank_spmm(g, SimRankConfig(iterations=3), impl=impl, device="cpu")
    v = g.n_nodes
    assert calls == [(v, v)] * 3
    kw = {"impl": "pallas", "interpret": True} if impl == "stream" else {"impl": "xla"}
    want = jexact.exact_simrank_spmm(small_random, JConfig(iterations=3), **kw)
    # the tolerance of tests/test_spmm.py:153 and :227 (sum orders differ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_fast16_transposes_bf16_iterates(small_random, monkeypatch):
    dtypes = []

    def seen(x):
        dtypes.append(x.dtype)
        return transpose.transpose_2d(x)

    monkeypatch.setattr(texact, "transpose_2d", seen)
    g = _to_torch(small_random)
    got = texact.exact_simrank_spmm(g, SimRankConfig(iterations=3), spmv_mode="fast",
                                    dtype=torch.bfloat16, device="cpu")
    assert dtypes == [torch.bfloat16] * 3
    want = jexact.exact_simrank_spmm(small_random, JConfig(iterations=3), impl="pallas",
                                     spmv_mode="fast", dtype=jnp.bfloat16, interpret=True)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 1e-2  # bf16 iterates, sums in other orders (test_fast16_matches_gold_ranking)
