"""Timing and durable logging (counterpart of ``graphtpu/utils/logging.py``).

``StopWatch`` mirrors ``lxctools/StopWatch.java:7-23`` (start/say with the
elapsed wall time); ``Log`` mirrors ``lxctools/Log.java:10-45`` (a
timestamped append log with a DURATION prefix per line).
"""

from __future__ import annotations

import time
from datetime import datetime


class StopWatch:
    _t0: float = time.time()

    @classmethod
    def start(cls) -> None:
        cls._t0 = time.time()

    @classmethod
    def elapsed(cls) -> float:
        return time.time() - cls._t0

    @classmethod
    def say(cls, msg: str) -> None:
        print(f"[{cls.elapsed():10.3f}s] {msg}", flush=True)


class Log:
    """Timestamped append log; each line carries the elapsed duration."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()
        self._f = open(path, "a")

    def info(self, msg: str) -> None:
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        self._f.write(f"{ts}\tDURATION {time.time() - self._t0:.3f}\t{msg}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
