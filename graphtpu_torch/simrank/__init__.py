from graphtpu_torch.simrank.exact import exact_simrank, simrank_topk
from graphtpu_torch.simrank.uniwalk import uniwalk_simrank
from graphtpu_torch.simrank.doublewalk import doublewalk_simrank
from graphtpu_torch.simrank.topsim import topsim_simrank

__all__ = [
    "exact_simrank",
    "simrank_topk",
    "uniwalk_simrank",
    "doublewalk_simrank",
    "topsim_simrank",
]
