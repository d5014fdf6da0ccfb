"""Named random streams (counterpart of ``graphtpu/core/prng.py``).

graphtpu derives every stream from a threefry key by ``fold_in``/``split``.
Here a key is a plain 63-bit integer: :func:`key_for` folds stream ids into
a seed through a splitmix64 chain, and :func:`generator` seeds a
``torch.Generator`` (Philox on a CUDA device) with it.  Streams are a pure
function of (seed, ids), so a run that is cut and resumed draws the same
numbers as one that was not.  The two packages draw different numbers
from the same seed; their tests compare deterministic pieces exactly and
random ones statistically.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
_MASK63 = (1 << 63) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key_for(seed: int, *stream: int) -> int:
    """A named stream: each id folded into the key in turn, so
    ``key_for(key_for(s, a), b) == key_for(s, a, b)``."""
    k = seed & _MASK63
    for s in stream:
        k = _splitmix64(k ^ _splitmix64(s & _MASK64)) & _MASK63
    return k


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(key)


def per_device_key(key: int, mesh, axis: str) -> int:
    """The key of this rank's own stream along ``axis`` of ``mesh``
    (graphtpu folds ``axis_index`` into the key inside ``shard_map``)."""
    return key_for(key, mesh.axis_index(axis))
