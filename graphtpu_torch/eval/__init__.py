"""Node-classification evaluation (counterpart of ``graphtpu/eval``)."""
