"""Embedding models (counterpart of ``graphtpu/models``)."""
