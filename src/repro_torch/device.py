"""Device resolution shared by the port's entry points.

Entry points default to ``cuda``. Asking for a card that is not there
raises: the port never falls back to the host on its own; a caller who
wants the host passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> a checked ``torch.device``
    (``"meta"`` too: shapes without storage, ``Model.param_shapes``)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the host")
    return dev
