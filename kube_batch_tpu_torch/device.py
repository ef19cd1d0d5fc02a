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


# Virtual shards per device for the solver's mesh (the counterpart of
# XLA's ``--xla_force_host_platform_device_count``): above 1,
# ``sharding.default_mesh`` repeats the session's device this many times.
# Process-wide, like the reference's flag; only ``sim --host-devices``
# and the tests set it.
_host_device_count = 1


def set_host_device_count(n: int) -> int:
    """Set the process's virtual shard count to ``n`` (>= 1) and return
    it. Counterpart of ``utils/backend.py::set_host_device_count``; the
    port has no frozen backend, so the count may also go down."""
    global _host_device_count
    n = int(n)
    if n < 1:
        raise ValueError(f"a shard count must be at least 1, not {n}")
    _host_device_count = n
    return n


def host_device_count() -> int:
    """The process's virtual shard count (1 unless set)."""
    return _host_device_count
