"""Per-row top-k extraction (counterpart of ``graphtpu/kernels/topk.py:28-60``).

``lax.top_k`` puts the lower index first among equal scores, and SimRank
has many exact ties between structurally equal nodes; ``torch.topk``
promises no order.  So both functions take a stable descending sort,
which keeps equal scores in index order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# rows per sort call, sized so one call sorts at most ~2^27 elements
_SORT_ELEMS = 1 << 27


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, v = x.shape
    rows = max(1, _SORT_ELEMS // max(v, 1))
    vals, idx = [], []
    for lo in range(0, b, rows):
        sv, si = torch.sort(x[lo : lo + rows], dim=1, descending=True, stable=True)
        vals.append(sv[:, :k])
        idx.append(si[:, :k])
    if not vals:
        return x.new_empty((0, k)), torch.empty((0, k), dtype=torch.int64, device=x.device)
    return torch.cat(vals), torch.cat(idx)


def topk_rows(
    scores: torch.Tensor,
    k: int,
    exclude_diag_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest entries per row of [B, V],
    ties in index order.  ``exclude_diag_offset=r`` masks column ``r + i``
    in row i.  When k > V the result is padded with value 0, index -1."""
    if exclude_diag_offset is not None:
        b = scores.shape[0]
        rows = torch.arange(b, device=scores.device)
        scores = scores.clone()
        scores[rows, exclude_diag_offset + rows] = float("-inf")
    k_eff = min(k, scores.shape[-1])
    vals, idx = _stable_topk(scores, k_eff)
    idx = idx.to(torch.int32)
    if k_eff < k:
        pad = k - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return vals, idx


def merge_topk(
    vals_a: torch.Tensor, idx_a: torch.Tensor, vals_b: torch.Tensor,
    idx_b: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row top-k sets into one (streamed tile reduction)."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    mv, mi = _stable_topk(vals, k)
    return mv, torch.gather(idx, 1, mi)
