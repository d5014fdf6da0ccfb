"""Training-state checkpointing (a copy of ``graphtpu/models/checkpoint.py``).

Training state (arrays, step and a JSON meta record) round-trips through
npz in graphtpu's format, so a checkpoint written by either package
resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


def save_state(
    path: str,
    arrays: Dict[str, Any],
    step: int = 0,
    meta: Optional[Dict] = None,
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__step__"] = np.asarray(step)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_state(path: str) -> Tuple[Dict[str, np.ndarray], int, Dict]:
    with np.load(path) as z:
        arrays = {
            k: z[k] for k in z.files if not k.startswith("__")
        }
        step = int(z["__step__"])
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z.files else {}
    return arrays, step, meta
