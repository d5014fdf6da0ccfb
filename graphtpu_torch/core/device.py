"""Where the port's entry points run, and at what float32 precision."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, by default ``cuda``.  Graphs are host-built data and say
    nothing of where the work runs; a missing card raises, never a quiet
    move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available")
    return dev


# jax.default_matmul_precision's names -> TF32 allowed in cuBLAS/cuDNN.
# Each name gets the cheapest Hopper mode no less accurate than what
# graphtpu asks of a TPU: "highest"/"float32" is full float32 there and
# here; "high"/"tensorfloat32" is three bf16 passes on a TPU (about 16
# significand bits), finer than TF32's 11 and not offered by cuBLAS through
# torch as a 3-pass TF32, so it runs in full float32 here (the name
# "tensorfloat32" does not mean TF32, since JAX treats it as "high");
# "default"/"bfloat16" is one bf16 pass (8 bits), which TF32 betters.
MATMUL_TF32 = {
    "default": True,
    "bfloat16": True,
    "high": False,
    "tensorfloat32": False,
    "highest": False,
    "float32": False,
}


@contextlib.contextmanager
def matmul_precision(name: str):
    """Float32 products inside the block at graphtpu's ``matmul_precision``
    ``name`` (see ``MATMUL_TF32``): TF32 on or off for matmuls and cuDNN,
    restored after.  An unknown name raises ValueError, as JAX does.  The
    CPU ignores the switch: there every name is full float32."""
    if name not in MATMUL_TF32:
        raise ValueError(f"matmul_precision {name!r}: must be one of {sorted(MATMUL_TF32)}")
    tf32 = MATMUL_TF32[name]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def full_fp32():
    """Float32 products in full float32 inside the block (TF32 off), JAX's
    "highest" precision: ``matmul_precision("highest")``."""
    return matmul_precision("highest")
