"""Typed configuration — the ``conf/MyConfiguration.java`` analog.

The reference centralises algorithm constants in one static-field class
(``conf/MyConfiguration.java:8-165``: C=0.6, TOPK=20, MIN=1e-9,
SEPARATOR=",") plus per-tool argparse (``node2vec/src/main.py:20-73``,
``DeepSim/src/main.py:18-80``).  Here every algorithm gets a frozen
dataclass with the reference defaults, so no kernel hides magic numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Global algorithm constants (conf/MyConfiguration.java:16-22)
C = 0.6              # SimRank decay
TOPK = 20            # default top-k
MIN_SIM = 1e-9       # similarity floor used by Eval filters
SEPARATOR = ","
SEPARATOR_KV = ":"


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """node2vec walk parameters (node2vec/src/main.py:35-57 defaults)."""

    num_walks: int = 10
    walk_length: int = 80
    p: float = 1.0
    q: float = 1.0
    # 'rejection' scales to any degree; 'exact' builds the full biased
    # categorical over padded neighbour rows (small graphs / parity tests).
    second_order_mode: str = "rejection"
    max_rejection_trials: int | None = None  # None: sized from (p, q)


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    """Skip-gram negative-sampling, gensim-Word2Vec-equivalent semantics
    (node2vec/src/main.py:92-101: size=128, window=10, min_count=0, sg=1,
    iter=10; gensim defaults negative=5, alpha=0.025, sample=1e-3)."""

    dim: int = 128
    window: int = 10
    epochs: int = 10
    negative: int = 5
    alpha: float = 0.025
    min_alpha: float = 0.0001
    batch_size: int = 8192       # center positions per optimizer step
    ns_exponent: float = 0.75
    subsample: float = 1e-3      # gensim 'sample'; 0 disables
    # True: one negative set per center, shared across its window (the
    # standard accelerator trick — 4-9x less gather/scatter traffic,
    # statistically equivalent quality).  False: gensim's per-pair draws.
    shared_negatives: bool = True
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class SimRankConfig:
    """Exact iterative SimRank (simrank/SimRank.java:15-77)."""

    c: float = C
    iterations: int = 3          # SimRank.java:16 (gold standard uses 30)
    topk: int = TOPK


@dataclasses.dataclass(frozen=True)
class WeightedSimRankConfig:
    """Weighted exact SimRank (simrank/weighted/WeightedSimRank.java:19-93)."""

    c: float = C
    iterations: int = 50         # WeightedSimRank.java:20
    topk: int = TOPK


@dataclasses.dataclass(frozen=True)
class UniWalkConfig:
    """Single-walk MC SimRank (simrank/SingleRandomWalk.java:19-92)."""

    c: float = C
    step: int = 5                # walk length = 2*step
    sample: int = 10000          # walkers per source (SingleRandomWalk.java:25)
    topk: int = TOPK
    source_tile: int = 256       # sources processed per device pass
    reuse_times: int = 1         # path reuse factor (SingleRandomWalkOptimal2.java:49-64)


@dataclasses.dataclass(frozen=True)
class DoubleWalkConfig:
    """Double-walk MC SimRank (simrank/DoubleRandomWalk.java:15-91)."""

    c: float = C
    step: int = 3
    sample: int = 200
    topk: int = TOPK
    source_tile: int = 64


@dataclasses.dataclass(frozen=True)
class TopSimConfig:
    """Deterministic-spreading TopSim (simrank/TopSim_singleSample.java:62-203).

    ``sample`` is the walker budget per source; a frontier node holding mass
    s >= degree splits evenly over all edges, otherwise draws ceil(s) random
    edges (budget-splitting, TopSim_singleSample.java:99-149)."""

    c: float = C
    step: int = 3
    sample: float = 10000.0
    topk: int = TOPK
    source_tile: int = 32
    # walker-slot capacity per source; bounds sum(children) = sample +
    # #parents, so 2x the budget never drops mass in practice
    frontier_capacity: int = 0  # 0 => 2 * ceil(sample) + 8
    normalize: bool = True  # divide by sample (reference leaves raw mass)
    # full path enumeration: ALWAYS split the budget over every edge,
    # never sample (TopSim_Enumerate.java:101-129 drops the
    # ``sample >= degree`` guard).  Exponential frontier — set
    # frontier_capacity explicitly for step > 2 (the reference demos a
    # single source for the same reason, TopSim_Enumerate.java:46-53).
    enumerate_all: bool = False


@dataclasses.dataclass(frozen=True)
class SDNEConfig:
    """SDNE scaffold autoencoder (SDNE/SDNE.py:66-134)."""

    units: Tuple[int, ...] = (784, 400, 100, 300, 784)
    learning_rate: float = 0.01
    minibatch: int = 100
    steps: int = 200000
    l2_coeff: float = 1e-1       # SDNE.py:109
    kl_coeff: float = 1e-1       # SDNE.py:122
    sparsity_p: float = 0.005    # SDNE.py:112
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DeepSimConfig:
    """DeepSim autoencoder (DeepSim/src/DeepSim.py:111-195)."""

    dim: int = 128
    learning_rate: float = 1e-3
    minibatch: int = 128
    steps: int = 50000
    window: int = 10             # target window 2k+1 around walk center
    topk: int = 10
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LEConfig:
    """Laplacian Eigenmaps (IsoMap_LE/LE.py:35-51)."""

    k_neighbors: int = 10
    heat_t: float = 15.0
    out_dim: int = 2
    eig_floor: float = 1e-5      # keep eigvalues > 1e-5 (LE.py:66-77)
