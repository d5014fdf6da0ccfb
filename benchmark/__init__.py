"""The benchmark of ``graphtpu_torch``: ``python3 benchmark/run.py --help``."""
