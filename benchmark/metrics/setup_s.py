"""Set-up: process start to the first timed call (imports, the CUDA
context, the kernels' build or load, the graph, the warm-up)."""


def read(rec):
    return rec["setup_s"]
