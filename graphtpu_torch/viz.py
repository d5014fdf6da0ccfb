"""Plots of the IsoMap_LE flows (counterpart of ``graphtpu/viz.py``).

Covers ``IsoMap_LE/LE.py:62-89`` (a scatter of the spectral embedding of
the swiss roll) and ``IsoMap_LE/simRank.py:127-179`` (a networkx spring
layout of a node's SimRank top-k neighbourhood).  Headless (Agg); every
function writes a PNG.  matplotlib and networkx are imported when a plot
is drawn, not with this module; a missing one raises an ImportError that
names it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_embedding_2d(
    y: np.ndarray,
    out_path: str,
    color: Optional[np.ndarray] = None,
    title: str = "spectral embedding",
) -> str:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(y[:, 0], y[:, 1], c=color, cmap="viridis", s=8)
    if color is not None:
        fig.colorbar(sc, ax=ax)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_swiss_roll_3d(x: np.ndarray, out_path: str, color=None) -> str:
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(x[:, 0], x[:, 1], x[:, 2], c=color, cmap="viridis", s=6)
    ax.set_title("swiss roll")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_simrank_neighborhood(
    sim_dict: Dict[int, List[Tuple[int, float]]],
    node: int,
    out_path: str,
    topk: int = 10,
    seed: int = 2,
) -> str:
    """Spring-layout drawing of ``node`` and its top-k similar nodes, edge
    widths proportional to similarity (``simRank.py:127-179``)."""
    plt = _pyplot()
    try:
        import networkx as nx
    except ImportError as e:
        raise ImportError("this plot needs networkx, which is not installed") from e

    gnx = nx.Graph()
    gnx.add_node(node)
    for dst, val in sim_dict.get(node, [])[:topk]:
        gnx.add_edge(node, dst, weight=val)
        # second ring: neighbours of neighbours that are also in the list
        for dst2, val2 in sim_dict.get(dst, [])[: topk // 2]:
            if dst2 in gnx.nodes:
                gnx.add_edge(dst, dst2, weight=val2)
    pos = nx.spring_layout(gnx, seed=seed)
    top = max(1e-9, max(dd["weight"] for _, _, dd in gnx.edges(data=True)))
    weights = [4.0 * d["weight"] / top for _, _, d in gnx.edges(data=True)]
    fig, ax = plt.subplots(figsize=(6, 5))
    nx.draw_networkx(
        gnx, pos, ax=ax, node_size=250,
        node_color=["tomato" if n == node else "skyblue" for n in gnx.nodes],
        width=weights, font_size=8,
    )
    ax.set_title(f"SimRank top-{topk} neighbourhood of {node}")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
