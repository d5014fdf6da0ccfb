"""Time the transpose kernel (``kernels/transpose.py``) at the gold cells' V.

    python -m graphtpu_torch.bench.transpose_probe [--v 32768] [--rounds 3]
        [--out probe.json]

On one card, for f32 and bf16: the first V rows of a [V+1, V] product (the
stream branch's ``ps[:v]``) transposed by the kernel and by the plain
``x.t().contiguous()``, and a device-to-device ``copy_`` of the same bytes
(the yardstick of what the card reaches), in turns for ``--rounds``
rounds, each time the median of 9 CUDA-event runs; the kernel's output is
checked bit-equal to the plain version's once.  The bound is
:func:`graphtpu_torch.bench.bounds.transpose_work` at 3.35 TB/s.  Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
from statistics import median

import torch

from graphtpu_torch.bench import bounds
from graphtpu_torch.bench.timing import card, cuda_ms
from graphtpu_torch.kernels import transpose


def transpose_times(dev, v: int, dtype, rounds: int = 3) -> dict:
    """The times of one dtype at [V, V] (see the module's docstring)."""
    x = torch.randn((v + 1, v), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).to(dtype)
    head = x[:v]
    if not torch.equal(transpose.transpose_2d(head), transpose.transpose_2d_plain(head)):
        raise RuntimeError(f"transpose kernel differs from the plain version ({dtype})")
    out = torch.empty_like(head)
    cases = {"kernel": lambda: transpose.transpose_2d(head),
             "plain": lambda: transpose.transpose_2d_plain(head),
             "copy": lambda: out.copy_(head)}
    runs = {k: [] for k in cases}
    for r in range(rounds):
        for k in (cases if r % 2 == 0 else reversed(cases)):
            runs[k].append(cuda_ms(cases[k]))
    bound_ms, bound_by = bounds.bound(*bounds.transpose_work(v, v, head.element_size()))
    ms = {k: median(t) for k, t in runs.items()}
    return dict(v=v, dtype=str(dtype).replace("torch.", ""), ms=ms["kernel"],
                plain_ms=ms["plain"], copy_ms=ms["copy"], bound_ms=bound_ms, bound_by=bound_by,
                of_copy=ms["copy"] / ms["kernel"], of_bound=bound_ms / ms["kernel"], runs=runs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v", type=int, default=32_768)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("transpose_probe needs a CUDA device")
    dev = torch.device("cuda")
    res = {"card": card(), "cases": []}
    for dtype in (torch.float32, torch.bfloat16):
        res["cases"].append(transpose_times(dev, args.v, dtype, args.rounds))
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
