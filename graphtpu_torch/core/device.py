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


@contextlib.contextmanager
def full_fp32():
    """Float32 products in full float32 inside the block: TF32 off for
    matmuls and cuDNN, as JAX's "highest" precision; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
