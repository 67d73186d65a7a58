"""Simulation-state checkpointing.

The port of `neptune_tpu/utils/checkpoint.py`, in the same file format: named
field arrays and a `__meta__` JSON record (step, time, extra metadata) in
one .npz, written atomically (a temporary file, then a rename). A file
written by either package loads in the other. Tensors are saved from the
host (`.detach().cpu().numpy()`); bfloat16, which NumPy cannot hold, is
refused.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch


def host_fields(fields: Mapping[str, object]) -> dict:
    """NumPy copies of named tensors (from any device) or arrays, as a
    checkpoint stores them; bfloat16 raises TypeError naming the field."""
    out = {}
    for name, v in fields.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                raise TypeError(
                    f"checkpoint field {name!r} is bfloat16, which NumPy cannot hold: "
                    "convert it (e.g. .float()) before saving"
                )
            v = v.detach().cpu().numpy()
        out[name] = np.asarray(v)
    return out


def save_checkpoint(
    path: str | Path,
    fields: Mapping[str, object],
    step: int = 0,
    time: float = 0.0,
    meta: Optional[dict] = None,
) -> None:
    """Write fields + metadata atomically (tmp file + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    for k in fields:
        if k in ("__meta__", "file"):
            raise ValueError(
                f"field name {k!r} is reserved ('__meta__' holds checkpoint "
                "metadata; 'file' collides with np.savez's first argument)"
            )
    payload = host_fields(fields)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"step": int(step), "time": float(time), **(meta or {})}).encode(),
        dtype=np.uint8,
    )
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """Returns (fields, meta); the fields are NumPy arrays."""
    with np.load(Path(path)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        fields = {k: z[k] for k in z.files if k != "__meta__"}
    return fields, meta
