"""Embedding models (counterpart of ``graphtpu/models``)."""

from graphtpu_torch.models.sgns import train_sgns, sgns_loss, build_negative_cdf

__all__ = ["train_sgns", "sgns_loss", "build_negative_cdf"]
