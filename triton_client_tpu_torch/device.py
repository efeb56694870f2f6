"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without
CUDA, a request for it raises: nothing silently runs on the CPU instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``), checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def instance_kind(device: torch.device) -> str:
    """A model config's ``instance_group`` kind for ``device``: the
    reference says ``KIND_TPU`` for its accelerator, the port ``KIND_GPU``."""
    return "KIND_CPU" if device.type == "cpu" else "KIND_GPU"
