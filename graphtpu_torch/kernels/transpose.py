"""A 2-D transpose into a new contiguous tensor: the copy between the two
products of each exact SimRank iteration (``simrank/exact.py``).

On a CUDA tensor :func:`transpose_2d` launches the hand kernel of
``csrc/transpose.cu`` (``gt_transpose_2d``: shared-memory tiles, 16-byte
loads and stores) on the current stream, or raises; on a CPU tensor it
runs :func:`transpose_2d_plain`.  graphtpu has no kernel here: it leaves
the transpose to XLA.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches, counted where the wrapper launches its kernel
TRANSPOSE_LAUNCHES = {"transpose": 0}
TRANSPOSE_DTYPES = (torch.float32, torch.bfloat16)


def transpose_2d_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x.t().contiguous()``."""
    return x.t().contiguous()


def transpose_2d(x: torch.Tensor) -> torch.Tensor:
    """``x`` [R, C], contiguous float32 or bfloat16, as a new contiguous
    [C, R] tensor with the same bits.

    A CPU tensor runs :func:`transpose_2d_plain`.  A CUDA tensor launches
    the kernel on the current stream, or raises; there is no other path.
    The output is the one allocation: no scratch.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in TRANSPOSE_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return transpose_2d_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"no transpose kernel for device {x.device}")
    return _transpose_cuda(x)


def _transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    from graphtpu_torch.kernels import _build

    r, c = x.shape
    out = torch.empty((c, r), dtype=x.dtype, device=x.device)
    if r == 0 or c == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        cu_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.gt_transpose_2d(x.data_ptr(), out.data_ptr(), r, c, x.element_size(),
                                 cu_stream)
    if rc != 0:
        raise RuntimeError(f"transpose kernel launch failed: {_build.error_string(rc)}")
    TRANSPOSE_LAUNCHES["transpose"] += 1
    return out
