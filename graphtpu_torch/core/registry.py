"""The dataset registry, the ``MyConfiguration`` dataset table
(counterpart of ``graphtpu/core/registry.py``).

The reference registers 19 undirected, unweighted datasets as parallel
arrays of paths and vertex counts (``conf/MyConfiguration.java:27-48``).
This is a name-keyed registry with explicit metadata; entries with a
``generator`` need no file.  Reference datasets register at import where
their files exist under ``$GRAPHTPU_REFERENCE_DATA``, the variable
graphtpu reads, so both packages see the same files; with the variable
unset nothing registers (graphtpu falls back to a fixed directory).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_nodes: int
    path: Optional[str] = None          # edge-list path if file-backed
    delimiter: Optional[str] = None
    weighted: bool = False
    directed: bool = False
    generator: Optional[Callable] = None  # () -> (edges, weights|None)
    labels_path: Optional[str] = None     # .mat for classification datasets


_REGISTRY: Dict[str, DatasetSpec] = {}


def register(spec: DatasetSpec) -> DatasetSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> DatasetSpec:
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


def load_graph(name: str, dedup: bool = True, device="cpu"):
    """The named dataset as a Graph (DiGraph if directed), tensors on
    ``device``."""
    from graphtpu_torch.core.graph import build_graph, read_edgelist_graph

    spec = get(name)
    if spec.path is not None:
        return read_edgelist_graph(
            spec.path, delimiter=spec.delimiter, weighted=spec.weighted,
            directed=spec.directed, n_nodes=spec.n_nodes, dedup=dedup, device=device,
        )
    if spec.generator is not None:
        edges, wts = spec.generator()
        return build_graph(edges, wts, n_nodes=spec.n_nodes, directed=spec.directed,
                           dedup=dedup, device=device)
    raise ValueError(f"dataset {name!r} has neither path nor generator")


def _maybe_register_reference_data():
    """Register the reference datasets whose files are present: the
    real-data entries of ``conf/MyConfiguration.java:29-48`` (blog
    V = 10,313, moreno_crime V = 1,380, arxiv V = 38,741) and node2vec's
    karate example (ids 1..34)."""
    ref = os.environ.get("GRAPHTPU_REFERENCE_DATA")
    if not ref:
        return
    entries = [
        ("blog", 10313, f"{ref}/DeepSim/lshrank_data/realdata/blog.txt", False),
        ("moreno_crime", 1380, f"{ref}/DeepSim/lshrank_data/realdata/moreno_crime_crime.txt", False),
        ("arxiv", 38741, f"{ref}/DeepSim/lshrank_data/realdata/arxiv_author_pub.txt", False),
        ("isomap_333", 333, f"{ref}/IsoMap_LE/data/0_333_5038.txt", False),
        ("karate", 35, f"{ref}/node2vec/graph/karate.edgelist", False),
    ]
    for name, n, path, directed in entries:
        if os.path.exists(path):
            register(DatasetSpec(name=name, n_nodes=n, path=path, directed=directed))
    mat = f"{ref}/node2vec/src/blogcatalog.mat"
    if os.path.exists(mat) and "blog" in _REGISTRY:
        register(dataclasses.replace(_REGISTRY["blog"], labels_path=mat))


_maybe_register_reference_data()
