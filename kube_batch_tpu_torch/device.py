"""Explicit device choice for the port's entry points.

Counterpart of the backend probes in ``kube_batch_tpu/utils/backend.py``.
The port runs on the card: an entry point given no device uses ``cuda``,
and raises when no CUDA device is present. The CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do; nothing falls
back to it silently.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``device`` if given,
    else ``cuda``. Raises RuntimeError when CUDA is asked for (or
    defaulted to) and no CUDA device is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
