from graphtpu_torch.walks.walker import uniform_walks, simulate_walks
from graphtpu_torch.walks.node2vec import node2vec_walks, node2vec_transition_probs
from graphtpu_torch.walks.alias import alias_setup, alias_draw, alias_sample

__all__ = [
    "uniform_walks",
    "simulate_walks",
    "node2vec_walks",
    "node2vec_transition_probs",
    "alias_setup",
    "alias_draw",
    "alias_sample",
]
