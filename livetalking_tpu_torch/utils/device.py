"""Device selection: the port's counterpart of ``JAX_PLATFORMS``.

Entry points run on the card unless the caller asks for the CPU. A CUDA
request on a host without a CUDA device raises; nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> ``torch.device``, checked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available "
            "(pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
