"""Node-classification evaluation (counterpart of ``graphtpu/eval``)."""

from graphtpu_torch.eval.f1 import topk_ranker_scoring, scoring_from_emb_file
from graphtpu_torch.eval.precision import (
    precision_at_k,
    precision_sim_dicts,
    ndcg_sim_dicts,
)

__all__ = [
    "topk_ranker_scoring",
    "scoring_from_emb_file",
    "precision_at_k",
    "precision_sim_dicts",
    "ndcg_sim_dicts",
]
