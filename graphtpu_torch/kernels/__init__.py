from graphtpu_torch.kernels.sampling import (
    uniform_neighbor,
    weighted_neighbor,
    edge_exists,
    row_cumulative_weights,
)
from graphtpu_torch.kernels.topk import topk_rows, bounded_topk_accumulate

__all__ = [
    "uniform_neighbor",
    "weighted_neighbor",
    "edge_exists",
    "row_cumulative_weights",
    "topk_rows",
    "bounded_topk_accumulate",
]
