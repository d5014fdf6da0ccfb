"""Batched source windows (counterpart of ``graphtpu/dist``)."""
