"""Relational result store, the ``dao/`` + ``utils/Print`` DB writers
(counterpart of ``graphtpu/io/db.py``).

The reference can persist edges and similarity results to SQL Server via
JDBC (``dao/JDBC.java:7-13``, ``dao/Dao.java:19-74``; writers in
``utils/Print.java:166-225``).  We provide the same capability on sqlite
(no external server in scope): an ``edges(src, dst, weight)`` table and a
``sims(src, dst, sim, algorithm)`` table with batch insert and top-k
query, matching the Dao interface shape.
"""

from __future__ import annotations

import sqlite3
from typing import List, Optional, Tuple

import numpy as np


class GraphStore:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        cur = self.conn.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS edges ("
            "src INTEGER, dst INTEGER, weight REAL DEFAULT 1.0)"
        )
        cur.execute(
            "CREATE TABLE IF NOT EXISTS sims ("
            "src INTEGER, dst INTEGER, sim REAL, algorithm TEXT)"
        )
        cur.execute("CREATE INDEX IF NOT EXISTS idx_sims_src ON sims(src)")
        self.conn.commit()

    # -- Dao.insertEdge / queryEdges equivalents --
    def insert_edges(
        self, edges: np.ndarray, weights: Optional[np.ndarray] = None
    ) -> None:
        edges = np.asarray(edges)
        if weights is None:
            weights = np.ones(len(edges), np.float32)
        self.conn.executemany(
            "INSERT INTO edges VALUES (?, ?, ?)",
            [
                (int(s), int(d), float(w))
                for (s, d), w in zip(edges, np.asarray(weights))
            ],
        )
        self.conn.commit()

    def query_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        rows = self.conn.execute("SELECT src, dst, weight FROM edges").fetchall()
        if not rows:
            return np.zeros((0, 2), np.int64), np.zeros(0, np.float32)
        arr = np.asarray(rows)
        return arr[:, :2].astype(np.int64), arr[:, 2].astype(np.float32)

    # -- Print.printByOrder(..., db) equivalents --
    def insert_topk(
        self,
        indices: np.ndarray,
        values: np.ndarray,
        algorithm: str,
        sources: Optional[np.ndarray] = None,
    ) -> None:
        indices = np.asarray(indices)
        values = np.asarray(values)
        srcs = (
            np.arange(indices.shape[0]) if sources is None else np.asarray(sources)
        )
        rows = []
        for i, src in enumerate(srcs):
            for j in range(indices.shape[1]):
                if indices[i, j] >= 0:
                    rows.append(
                        (int(src), int(indices[i, j]), float(values[i, j]), algorithm)
                    )
        self.conn.executemany("INSERT INTO sims VALUES (?, ?, ?, ?)", rows)
        self.conn.commit()

    def query_topk(
        self, src: int, k: int, algorithm: Optional[str] = None
    ) -> List[Tuple[int, float]]:
        if algorithm:
            rows = self.conn.execute(
                "SELECT dst, sim FROM sims WHERE src=? AND algorithm=? "
                "ORDER BY sim DESC LIMIT ?",
                (src, algorithm, k),
            ).fetchall()
        else:
            rows = self.conn.execute(
                "SELECT dst, sim FROM sims WHERE src=? ORDER BY sim DESC LIMIT ?",
                (src, k),
            ).fetchall()
        return [(int(d), float(s)) for d, s in rows]

    def close(self) -> None:
        self.conn.close()
