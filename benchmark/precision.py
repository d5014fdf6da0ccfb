"""The precisions a configuration (or a control) may name: each maps to the
program's ``spmv_mode`` and the dtype of its iterates, as the CLI's
``--mode`` does (``graphtpu_torch/cli.py``)."""

MODES = {"kahan": ("kahan", "float32"), "fast": ("fast", "float32"),
         "fast16": ("fast", "bfloat16")}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
